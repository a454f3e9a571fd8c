// Native sparsity/topology builder — the host-side runtime core.
//
// Role of the reference's BSRFormat::computeSparsity pipeline
// (femutils/BSRFormat.h:583-744: packed-edge build + GPU sort + atomic
// neighbor count + exclusive-scan row index + atomic column scatter) for the
// device build's host preprocessing: given cell connectivity buckets, produce
//   * the node-graph CSR (row_ptr, cols),
//   * the padded BELL layout (ell width, ell cols, validity),
//   * the per-cell-entry flat slot map used by the device segment-sum
//     assembly (the static replacement for findValueIndex searches,
//     BSRFormat.h:145-171).
//
// Algorithm: counting-sort entries by row (exact, stable), then per-row
// sort+dedupe of columns (rows have bounded degree), then a second pass
// assigns every original (cell,i,j) entry its flat ELL slot.  O(E) memory
// traffic, no global sort — ~20x faster than the numpy unique() path on a
// single core.
//
// C API (ctypes): two-phase — build() returns a handle + sizes, fill()
// copies results into caller-allocated numpy buffers, free() releases.

#include <algorithm>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

struct Topo {
  int64_t n_nodes = 0;
  int32_t width = 0;
  int64_t nnz = 0;
  std::vector<int64_t> row_ptr;     // n_nodes+1
  std::vector<int32_t> csr_cols;    // nnz
  std::vector<int32_t> csr_to_ell;  // nnz (flat ELL slot of each CSR entry)
  std::vector<int32_t> diag_slot;   // n_nodes
  std::vector<int32_t> ell_cols;    // n_nodes*width
  std::vector<uint8_t> ell_valid;   // n_nodes*width
  std::vector<std::vector<int32_t>> slot_maps;  // per bucket: nc*npc*npc
};

}  // namespace

extern "C" {

void* afem_topo_build(int64_t n_nodes, int32_t n_buckets,
                      const int32_t** conns, const int64_t* ncs,
                      const int32_t* npcs, int32_t pad_width_to) {
  auto* t = new Topo();
  t->n_nodes = n_nodes;

  // total raw entries
  int64_t E = 0;
  for (int32_t b = 0; b < n_buckets; ++b)
    E += ncs[b] * (int64_t)npcs[b] * npcs[b];

  // ---- pass 1: count entries per row ------------------------------------
  std::vector<int64_t> count(n_nodes + 1, 0);
  for (int32_t b = 0; b < n_buckets; ++b) {
    const int32_t* c = conns[b];
    const int64_t nc = ncs[b];
    const int32_t npc = npcs[b];
    for (int64_t e = 0; e < nc; ++e) {
      const int32_t* nodes = c + e * npc;
      for (int32_t i = 0; i < npc; ++i) count[nodes[i] + 1] += npc;
    }
  }
  std::vector<int64_t> start(n_nodes + 1, 0);
  for (int64_t r = 0; r < n_nodes; ++r) start[r + 1] = start[r] + count[r + 1];

  // ---- pass 2: scatter (col, orig_entry_idx) grouped by row --------------
  std::vector<int32_t> ecol(E);
  std::vector<int64_t> eidx(E);
  {
    std::vector<int64_t> cur(start.begin(), start.end() - 1);
    int64_t base = 0;
    for (int32_t b = 0; b < n_buckets; ++b) {
      const int32_t* c = conns[b];
      const int64_t nc = ncs[b];
      const int32_t npc = npcs[b];
      for (int64_t e = 0; e < nc; ++e) {
        const int32_t* nodes = c + e * npc;
        for (int32_t i = 0; i < npc; ++i) {
          int64_t p = cur[nodes[i]];
          for (int32_t j = 0; j < npc; ++j) {
            ecol[p] = nodes[j];
            eidx[p] = base + (e * npc + i) * npc + j;
            ++p;
          }
          cur[nodes[i]] = p;
        }
      }
      base += nc * (int64_t)npc * npc;
    }
  }

  // ---- per-row dedupe: CSR + width --------------------------------------
  t->row_ptr.assign(n_nodes + 1, 0);
  std::vector<int32_t> scratch;
  int32_t width = 1;
  // first sweep: unique count per row (sorting each row's slice in place)
  for (int64_t r = 0; r < n_nodes; ++r) {
    int64_t lo = start[r], hi = start[r + 1];
    if (lo == hi) {
      t->row_ptr[r + 1] = t->row_ptr[r];
      continue;
    }
    // sort the (col, idx) slice by col, stable not needed
    // sort indices locally to keep ecol/eidx aligned
    scratch.resize(hi - lo);
    std::vector<int64_t> perm(hi - lo);
    for (int64_t k = 0; k < hi - lo; ++k) perm[k] = k;
    std::sort(perm.begin(), perm.end(), [&](int64_t a, int64_t bb) {
      return ecol[lo + a] < ecol[lo + bb];
    });
    std::vector<int32_t> c2(hi - lo);
    std::vector<int64_t> i2(hi - lo);
    for (int64_t k = 0; k < hi - lo; ++k) {
      c2[k] = ecol[lo + perm[k]];
      i2[k] = eidx[lo + perm[k]];
    }
    std::memcpy(&ecol[lo], c2.data(), c2.size() * sizeof(int32_t));
    std::memcpy(&eidx[lo], i2.data(), i2.size() * sizeof(int64_t));
    int32_t uniq = 1;
    for (int64_t k = lo + 1; k < hi; ++k)
      if (ecol[k] != ecol[k - 1]) ++uniq;
    width = std::max(width, uniq);
    t->row_ptr[r + 1] = t->row_ptr[r] + uniq;
  }
  if (pad_width_to > 1)
    width = ((width + pad_width_to - 1) / pad_width_to) * pad_width_to;
  t->width = width;
  t->nnz = t->row_ptr[n_nodes];

  // ---- build ELL + slot assignments --------------------------------------
  t->csr_cols.resize(t->nnz);
  t->csr_to_ell.resize(t->nnz);
  t->diag_slot.assign(n_nodes, 0);
  t->ell_cols.resize((size_t)n_nodes * width);
  t->ell_valid.assign((size_t)n_nodes * width, 0);
  // padding columns point at the own row (safe zero-valued gather)
  for (int64_t r = 0; r < n_nodes; ++r)
    for (int32_t w = 0; w < width; ++w)
      t->ell_cols[(size_t)r * width + w] = (int32_t)r;

  std::vector<int32_t> eslot(E);  // flat ELL slot of each original entry
  for (int64_t r = 0; r < n_nodes; ++r) {
    int64_t lo = start[r], hi = start[r + 1];
    int64_t cbase = t->row_ptr[r];
    int32_t w = -1;
    int32_t prev = -1;
    for (int64_t k = lo; k < hi; ++k) {
      if (ecol[k] != prev) {
        ++w;
        prev = ecol[k];
        t->csr_cols[cbase + w] = prev;
        t->csr_to_ell[cbase + w] = (int32_t)(r * width + w);
        t->ell_cols[(size_t)r * width + w] = prev;
        t->ell_valid[(size_t)r * width + w] = 1;
        if (prev == (int32_t)r) t->diag_slot[r] = (int32_t)(r * width + w);
      }
      eslot[eidx[k]] = (int32_t)(r * width + w);
    }
  }
  // release intermediates before copying slot maps out
  ecol.clear(); ecol.shrink_to_fit();
  eidx.clear(); eidx.shrink_to_fit();

  // ---- split eslot back into per-bucket slot maps ------------------------
  t->slot_maps.resize(n_buckets);
  int64_t base = 0;
  for (int32_t b = 0; b < n_buckets; ++b) {
    int64_t n = ncs[b] * (int64_t)npcs[b] * npcs[b];
    t->slot_maps[b].assign(eslot.begin() + base, eslot.begin() + base + n);
    base += n;
  }
  return t;
}

int32_t afem_topo_width(void* h) { return ((Topo*)h)->width; }
int64_t afem_topo_nnz(void* h) { return ((Topo*)h)->nnz; }

void afem_topo_fill(void* h, int64_t* row_ptr, int32_t* csr_cols,
                    int32_t* csr_to_ell, int32_t* diag_slot,
                    int32_t* ell_cols, uint8_t* ell_valid,
                    int32_t** slot_maps) {
  Topo* t = (Topo*)h;
  std::memcpy(row_ptr, t->row_ptr.data(), t->row_ptr.size() * sizeof(int64_t));
  std::memcpy(csr_cols, t->csr_cols.data(), t->csr_cols.size() * sizeof(int32_t));
  std::memcpy(csr_to_ell, t->csr_to_ell.data(), t->csr_to_ell.size() * sizeof(int32_t));
  std::memcpy(diag_slot, t->diag_slot.data(), t->diag_slot.size() * sizeof(int32_t));
  std::memcpy(ell_cols, t->ell_cols.data(), t->ell_cols.size() * sizeof(int32_t));
  std::memcpy(ell_valid, t->ell_valid.data(), t->ell_valid.size() * sizeof(uint8_t));
  for (size_t b = 0; b < t->slot_maps.size(); ++b)
    std::memcpy(slot_maps[b], t->slot_maps[b].data(),
                t->slot_maps[b].size() * sizeof(int32_t));
}

void afem_topo_free(void* h) { delete (Topo*)h; }

}  // extern "C"
