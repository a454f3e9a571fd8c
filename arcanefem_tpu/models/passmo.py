"""Passmo: general-element transient elastodynamics (the "full FEM" module).

JAX rebuild of reference modules/passmo (ElastodynamicModule.cc,
Elastodynamic.axl) at full option-surface depth:

* arbitrary cell types per mesh (tria3/6, quad4/8, tetra4/10, hexa8/20,
  penta6, pyramid5 — mixed meshes bucket by type, SURVEY.md §7 hard part 6)
  with persistent per-Gauss-point state (ops/gauss_state.py, the
  GaussDoFsOnCells role, ElastodynamicModule.cc:188-253);
* Newmark-β / Generalized-α displacement form
      (cm·M + ck·K + c1·Mparax)·d_{n+1} = M(cm·u_pred − αm·a_n) − αf·K·d_n
                                          + f_ext + f_parax
  (ElastodynamicModule.cc:1707-1793 LHS, 1798-2104 RHS, 554-591 update);
* per-region elastic properties from mesh `<initialization>` variables AND
  `<init-elast-properties>` blocks with young/lame/veloc conversions
  (ElastodynamicModule.cc:331-382);
* imposed displacement / velocity / acceleration / force on surfaces and
  node groups, constant or time-history CaseTable curves with x/y/z-axis
  selectors (Elastodynamic.axl:202-330; masks ElastodynamicModule.cc:595-748,
  per-step values :900-1190).  Imposed-acceleration/velocity DoFs follow the
  reference's Newmark overrides (:567-582): d ← u_pred + β·dt²·a_imposed and
  v ← v_imposed.  NOTE the reference's asymmetry is preserved: point
  conditions with imposed A/V also Dirichlet-constrain the displacement
  (:736-746) while surface conditions do not (:655-657);
* Neumann tractions, constant or CaseTable curve (:1194-1230, 2308-2338) —
  consistent Gauss face loads here instead of the reference's equal
  per-node lumping;
* paraxial absorbing boundaries on the general face zoo (line2/3, tria3/6,
  quad4/8): LHS c1·∫φφ·P(n) and RHS ∫φφ·P(n)(c1·u_pred − c0·v_pred − αf·v_n)
  with P(n) = ρ(cs(I−n⊗n) + cp·n⊗n) (:1639-1703, 2107-2221; ops/faces.py),
  outer-domain properties from (E,ν)/(λ,μ)/(cp,cs) or the inner boundary
  cell (:789-856 — including fixing the reference's `cs = getCp()` slip at
  :805), and incident input motions (analytic Harmonic/Ricker/Decay/Tsang/
  Dirac or type-6 file curves, analytic_func.cc).  The reference stores the
  incident motion per face but never adds it to the RHS (dead code,
  ElastodynamicModule.cc:2133-2141); here `paraxial_incident=True` (default)
  adds the standard 2·P(n)·v_in incident traction so input motions actually
  inject waves;
* initial node conditions (U/V/A/F on node groups, :302-327) and initial
  cell conditions (vol/dev stress/strain tensors, :384-408);
* double-couple point sources with seismic-moment or loading time
  histories and xy/yz/xz source planes (:1967-2103);
* stress/strain recovery: volume-weighted per-cell Voigt strain and
  linear-elastic stress including the initial cell tensors — the
  StrainVol/StrainDev/StressVol/StressDev output variables the reference
  declares (Elastodynamic.axl:41-52) but never fills; written to the
  VTKHDF post-processing path and optional text files.

The reference rebuilds the operator every `linop-nstep` steps
(ElastodynamicModule.cc:488-499); here the operator is frozen once (the
sparsity and coefficients are time-independent) and each step is RHS-only
with per-step Dirichlet values applied through the frozen masks.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace

import jax
import jax.numpy as jnp
import numpy as np

from ..fem.bcs import BoundaryConditions, dtype_safe_penalty
from ..fem.casetable import CaseTable
from ..fem.problem import FemProblem
from ..fem.timer import PhaseTimer
from ..fem.transient import anchor_atol
from ..fem.validation import check_node_results
from ..mesh.core import Mesh
from ..ops import faces as F
from ..solver.linear_system import SolverOptions, solve_finalized
from ..solver.iterative import make_precond

_3NONE = (None, None, None)


# --------------------------------------------------------------------------
# analytic incident-motion functions (modules/passmo/analytic_func.cc)
# --------------------------------------------------------------------------


@dataclass
class AnalyticInput:
    """Parameters of the analytical input motions (Elastodynamic.axl:388-425)."""

    tp: float = 1.0
    ts: float = 1.0
    coef: float = 1.0
    amplit: float = 1.0
    phase: float = 0.0
    order: int = 2

    def ricker(self, t: float) -> float:
        x = math.pi * (t - self.ts) / self.tp
        x2 = x * x
        e = self.amplit * math.exp(-x2)
        if self.order == 0:
            return e
        if self.order == 1:
            return -math.sqrt(2.0) * math.exp(0.5) * e * x
        if self.order == 3:
            k = 1.5 - math.sqrt(1.5)
            return math.exp(k) * e * (1.5 - x2) * x / math.sqrt(1.5 * k)
        return 0.5 * math.exp(1.5) * e * (x2 - 0.5)  # default order 2

    def harmonic(self, t: float) -> float:
        return self.amplit * math.sin(2 * math.pi * t / self.tp + self.phase)

    def decay(self, t: float) -> float:
        return self.amplit * math.exp(max(-700.0, -self.coef * t))

    def tsang(self, t: float) -> float:
        return self.decay(t) * math.sin(2 * math.pi * t / self.tp + self.phase)

    def dirac(self, t: float, dt: float) -> float:
        return self.amplit if abs(t - self.tp) < 0.5 * dt else 0.0

    def value(self, typ: int, t: float, dt: float) -> float:
        return {1: self.harmonic, 2: self.ricker, 3: self.decay,
                4: self.tsang}.get(typ, lambda tt: self.dirac(tt, dt))(t)


# --------------------------------------------------------------------------
# condition dataclasses (the Elastodynamic.axl option surface)
# --------------------------------------------------------------------------


@dataclass
class ImposedCond:
    """dirichlet-surface-condition / dirichlet-point-condition
    (Elastodynamic.axl:202-330): constant U/V/A/F per component plus
    optional 3-column time-history curves gated by the x/y/z-axis flags."""

    group: str
    is_surface: bool = True
    U: tuple = _3NONE
    V: tuple = _3NONE
    A: tuple = _3NONE
    Fv: tuple = _3NONE
    u_curve: CaseTable | None = None
    v_curve: CaseTable | None = None
    a_curve: CaseTable | None = None
    f_curve: CaseTable | None = None
    axes: tuple = (False, False, False)

    def comps(self, kind: str, ndof: int) -> list[int]:
        const = {"u": self.U, "v": self.V, "a": self.A, "f": self.Fv}[kind]
        curve = getattr(self, f"{kind}_curve")
        return [
            c for c in range(ndof)
            if (const[c] is not None) or (curve is not None and self.axes[c])
        ]


@dataclass
class NeumannCond:
    surface: str
    t: tuple = _3NONE
    curve: CaseTable | None = None


@dataclass
class ParaxialCond:
    """paraxial-boundary-condition (Elastodynamic.axl:357-426)."""

    surface: str
    rho: float | None = None
    cs: float | None = None
    cp: float | None = None
    E: float | None = None
    nu: float | None = None
    lam: float | None = None
    mu: float | None = None
    input_type: int = 0
    analytic: AnalyticInput = field(default_factory=AnalyticInput)
    u_input: CaseTable | None = None
    v_input: CaseTable | None = None
    a_input: CaseTable | None = None
    normal_angle: float = 0.0
    in_plane_angle: float = 0.0


@dataclass
class ElastProps:
    """init-elast-properties block (Elastodynamic.axl:146-176)."""

    cell_group: str
    rho: float = 2500.0
    young: float = 0.0
    nu: float = 0.0
    lam: float = 0.0
    mu: float = 0.0
    vp: float = 0.0
    vs: float = 0.0


@dataclass
class InitCellCond:
    """init-cell-condition block: initial Voigt tensors per cell group
    (vol = xx yy zz, dev = xy yz xz; Elastodynamic.axl:178-199)."""

    cell_group: str
    vol_stress: tuple = (0.0, 0.0, 0.0)
    vol_strain: tuple = (0.0, 0.0, 0.0)
    dev_stress: tuple = (0.0, 0.0, 0.0)
    dev_strain: tuple = (0.0, 0.0, 0.0)


@dataclass
class InitNodeCond:
    """initial-node-condition block (Elastodynamic.axl:429-446)."""

    node_group: str
    U: tuple | None = None
    V: tuple | None = None
    A: tuple | None = None
    Fv: tuple | None = None


@dataclass
class PassmoDoubleCouple:
    """double-couple block (Elastodynamic.axl:490-523): Ft from a seismic
    moment M0(t)/distance or a direct loading history; source plane selects
    the force components (ElastodynamicModule.cc:1997-2006)."""

    north: str
    south: str
    east: str
    west: str
    source_plane: int = 0  # 0=xy, 1=yz, 2=xz
    moment_table: CaseTable | None = None
    loading_table: CaseTable | None = None
    dew: float = 1.0
    dns: float = 1.0


@dataclass
class PassmoConfig:
    analysis_type: str = "planestrain"
    start: float = 0.0
    tmax: float = 1.0
    dt: float = 0.1
    beta: float = 0.25
    gamma: float = 0.5
    # Generalized-alfa (Chung–Hulbert): the reference declares these options
    # (Elastodynamic.axl:476-483 alfam/alfaf/alfa_method) but fatals on use
    # ("Generalized-alfa will be done later", ElastodynamicModule.cc:1756);
    # implemented here: M a_{n+1-αm} + K d_{n+1-αf} = 0 in displacement form
    alfa_method: bool = False
    alfam: float = 0.0
    alfaf: float = 0.0
    ninteg: int = 2  # gauss-nint (Elastodynamic.axl:448)
    gravity: tuple = (0.0, 0.0, 0.0)  # gx/gy/gz options
    # material per cell group: name -> value (mesh <initialization>)
    rho: dict = field(default_factory=dict)
    lam: dict = field(default_factory=dict)
    mu: dict = field(default_factory=dict)
    elast_type: str = ""  # init-elast-type: young|lame|veloc
    init_props: list = field(default_factory=list)  # [ElastProps]
    init_cells: list = field(default_factory=list)  # [InitCellCond]
    init_nodes: list = field(default_factory=list)  # [InitNodeCond]
    conditions: list = field(default_factory=list)  # [ImposedCond]
    neumann: list = field(default_factory=list)  # [NeumannCond]
    paraxial: list = field(default_factory=list)  # [ParaxialCond]
    double_couple: list = field(default_factory=list)  # [PassmoDoubleCouple]
    paraxial_incident: bool = True  # add 2·P·v_in (reference stores only)
    bcs: BoundaryConditions = field(default_factory=BoundaryConditions)
    penalty: float = 1.0e30
    method: str = "Penalty"
    solver: SolverOptions = field(default_factory=SolverOptions)
    result_file: str | None = None
    result_epsilon: float = 1.0e-4  # _checkResultFile epsilon
    result_min_value: float = 1.0e-10
    recover_fields: bool = True
    stress_file: str | None = None
    strain_file: str | None = None


@dataclass
class PassmoResult:
    u: np.ndarray
    v: np.ndarray
    a: np.ndarray
    steps: int
    problem: FemProblem
    # per-cell Voigt recovery: {cell_type: (nc, 3)} — the StrainVol/StrainDev/
    # StressVol/StressDev cell variables (Elastodynamic.axl:41-52)
    strain_vol: dict | None = None
    strain_dev: dict | None = None
    stress_vol: dict | None = None
    stress_dev: dict | None = None


# --------------------------------------------------------------------------
# material / group helpers
# --------------------------------------------------------------------------


def _rows_in_bucket(cells: np.ndarray, sel: np.ndarray) -> np.ndarray:
    from .fourier import _rows_in_bucket as rib

    return rib(cells, sel)


def _per_cell(mesh: Mesh, group_values: dict, default: float = 0.0):
    """name->value group map to per-bucket (nc,) arrays (the reference's
    mesh-initialized cell variables m_rho/m_lambda/m_mu)."""
    out = {ct: np.full(c.shape[0], default) for ct, c in mesh.cells.items()}
    for group, value in group_values.items():
        for ct, sel in mesh.cell_groups.get(group, {}).items():
            out[ct][_rows_in_bucket(mesh.cells[ct], sel)] = value
    return out


def _group_rows(mesh: Mesh, group: str):
    """[(cell_type, row_indices)] for a named cell group."""
    out = []
    for ct, sel in mesh.cell_groups.get(group, {}).items():
        out.append((ct, _rows_in_bucket(mesh.cells[ct], sel)))
    return out


def _resolve_materials(mesh: Mesh, cfg: PassmoConfig):
    """Per-bucket (rho, lam, mu, vp, vs) cell arrays.

    Precedence: mesh `<initialization>` Rho/Lambda/Mu variables first, then
    `<init-elast-properties>` blocks with the init-elast-type conversion
    (_applyInitialCellConditions, ElastodynamicModule.cc:334-382)."""
    rho_c = _per_cell(mesh, cfg.rho)
    lam_c = _per_cell(mesh, cfg.lam)
    mu_c = _per_cell(mesh, cfg.mu)
    et = (cfg.elast_type or "").lower()
    for p in cfg.init_props:
        rho = p.rho
        if "young" in et or (not et and p.young):
            E, nu = p.young, p.nu
            lam = nu * E / (1 + nu) / (1 - 2 * nu)
            mu = E / 2.0 / (1 + nu)
        elif "lame" in et or (not et and (p.lam or p.mu)):
            lam, mu = p.lam, p.mu
        elif "veloc" in et or (not et and (p.vp or p.vs)):
            mu = rho * p.vs**2
            lam = rho * p.vp**2 - 2 * mu
        else:
            raise ValueError(
                "init-elast-properties needs init-elast-type young|lame|veloc"
            )
        for ct, rows in _group_rows(mesh, p.cell_group):
            rho_c[ct][rows] = rho
            lam_c[ct][rows] = lam
            mu_c[ct][rows] = mu
    vp_c, vs_c = {}, {}
    for ct in rho_c:
        with np.errstate(divide="ignore", invalid="ignore"):
            vs_c[ct] = np.where(
                rho_c[ct] > 0, np.sqrt(np.abs(mu_c[ct]) / rho_c[ct]), 0.0
            )
            vp_c[ct] = np.where(
                rho_c[ct] > 0,
                np.sqrt(np.abs(lam_c[ct] + 2 * mu_c[ct]) / rho_c[ct]),
                0.0,
            )
    return rho_c, lam_c, mu_c, vp_c, vs_c


# --------------------------------------------------------------------------
# imposed-condition machinery
# --------------------------------------------------------------------------


class _Channel:
    """One (condition, kind) write set: dofs + constant values or a curve.

    Per-step evaluation scatters the (3,) value vector onto the dofs —
    the _applyDirichletBoundaryConditions value writes
    (ElastodynamicModule.cc:900-1190), order-preserving (later wins)."""

    def __init__(self, dofs_by_comp, const, curve):
        self.entries = [(jnp.asarray(d), c) for c, d in dofs_by_comp]
        self.const = const
        self.curve = curve

    def write(self, vec: jnp.ndarray, t: float) -> jnp.ndarray:
        vals = (
            np.asarray(self.curve.value(t))
            if self.curve is not None
            else np.array([v if v is not None else 0.0 for v in self.const])
        )
        for dofs, c in self.entries:
            vec = vec.at[dofs].set(float(vals[c]))
        return vec


def _build_channels(mesh: Mesh, prob: FemProblem, conds: list[ImposedCond]):
    """masks (imp_u explicit / dir / v / a / f) + per-kind channel lists."""
    n = prob.n_dofs
    ndof = prob.ndof
    masks = {k: np.zeros(n, bool) for k in ("u", "dir", "v", "a", "f")}
    channels = {k: [] for k in ("u", "v", "a", "f")}
    for cond in conds:
        nodes = mesh.group_nodes(cond.group)
        for kind in ("u", "v", "a", "f"):
            comps = cond.comps(kind, ndof)
            if not comps:
                continue
            dbc = [(c, prob.dof_ids(nodes, c)) for c in comps]
            for c, d in dbc:
                masks[kind][d] = True
            const = {"u": cond.U, "v": cond.V, "a": cond.A, "f": cond.Fv}[kind]
            channels[kind].append(
                _Channel(dbc, const, getattr(cond, f"{kind}_curve"))
            )
        # Dirichlet rows: explicit U always; point conditions also constrain
        # components with imposed A/V (ElastodynamicModule.cc:736-746 —
        # surface conditions do NOT, :655-657)
        dir_comps = set(cond.comps("u", ndof))
        if not cond.is_surface:
            dir_comps |= set(cond.comps("a", ndof)) | set(cond.comps("v", ndof))
        for c in dir_comps:
            masks["dir"][prob.dof_ids(nodes, c)] = True
    return masks, channels


# --------------------------------------------------------------------------
# solve
# --------------------------------------------------------------------------


def solve(mesh: Mesh, cfg: PassmoConfig, dtype=np.float64,
          timer: PhaseTimer | None = None) -> PassmoResult:
    timer = timer or PhaseTimer(verbose=False)
    ndof = 3 if (mesh.dim == 3 or cfg.analysis_type.lower() == "3d") else 2
    beta, gamma, dt = cfg.beta, cfg.gamma, cfg.dt
    am, af = (cfg.alfam, cfg.alfaf) if cfg.alfa_method else (0.0, 0.0)
    dt2 = dt * dt
    cab = 1.0 / (beta * dt2)  # Newmark acceleration recovery factor
    cm = (1.0 - am) * cab  # mass LHS factor ((1-αm)/(β·dt²))
    # paraxial Newmark factors (_getParaxialContribution,
    # ElastodynamicModule.cc:2113-2117)
    pc0 = 1.0 - af
    pc1 = pc0 * gamma / (beta * dt)

    with timer.phase("initialize"):
        prob = FemProblem(mesh, ndof=ndof, dtype=dtype)

    rho_c, lam_c, mu_c, vp_c, vs_c = _resolve_materials(mesh, cfg)

    with timer.phase("lhs-matrix-assembly"):
        # persistent per-Gauss-point state, built ONCE and reused by both
        # matrices and the stress/strain recovery — the GaussDoFsOnCells
        # role, ElastodynamicModule.cc:188-253
        from ..ops.gauss_state import GaussState

        coords_d = jnp.asarray(mesh.coords.astype(dtype))
        gstate = GaussState.build(mesh, coords_d, cfg.ninteg, ndof)
        Mm = prob.assemble_matrix(
            lambda ct, xyz: gstate.mass_blocks(
                ct, jnp.asarray(rho_c[ct])[None, :]
            )
        )
        Km = prob.assemble_matrix(
            lambda ct, xyz: gstate.stiffness_blocks(
                ct,
                jnp.asarray(lam_c[ct])[None, :],
                jnp.asarray(mu_c[ct])[None, :],
            )
        )
        A = Mm.with_values(cm * Mm.values + (1.0 - af) * Km.values)

        # paraxial LHS: c1·∫φφ·P(n) face blocks
        # (_assembleLHSParaxialContribution, ElastodynamicModule.cc:2226-2304)
        parax = []  # (conn_j, dofs_j, mass (nf,nfn,nfn), P (nf,b,b), aux)
        for pc in cfg.paraxial:
            for ftype, conn in mesh.face_groups[pc.surface].items():
                normals = F.outward_normals(mesh, ftype, conn)
                rho, cs, cp = _paraxial_props(mesh, pc, conn, rho_c, vs_c, vp_c)
                P = jnp.asarray(
                    F.paraxial_direction_matrix(normals, rho, cs, cp, ndof)
                    .astype(dtype)
                )
                mass = F.face_mass(ftype, prob.face_xyz(conn), cfg.ninteg)
                blocks = pc1 * jnp.einsum("fij,fab->fijab", mass, P)
                A = _add_face_blocks(prob, A, conn, blocks)
                load = F.face_load(ftype, prob.face_xyz(conn), cfg.ninteg)
                parax.append((pc, jnp.asarray(conn.astype(np.int64)), mass, P, load))

    # ---- imposed-condition masks + channels -------------------------------
    conds = list(cfg.conditions)
    for bc in cfg.bcs.dirichlet:  # legacy surface-Dirichlet surface
        conds.append(
            ImposedCond(group=bc.surface, is_surface=True,
                        U=tuple(bc.values or _3NONE) + _3NONE[len(bc.values or ()):])
        )
    masks, channels = _build_channels(mesh, prob, conds)
    dir_mask = masks["dir"]
    impu = jnp.asarray(masks["u"])
    impv = jnp.asarray(masks["v"])
    impa = jnp.asarray(masks["a"])
    impf = jnp.asarray(masks["f"])
    dirm = jnp.asarray(dir_mask)

    # ---- frozen BC matrix ---------------------------------------------------
    pen = dtype_safe_penalty(cfg.penalty, dtype)
    system = prob.new_system(A, cfg.solver)
    dir_dofs = np.nonzero(dir_mask)[0]
    method = (cfg.method or "Penalty").lower()
    prob.apply_dirichlet(
        system, dir_dofs, jnp.zeros(len(dir_dofs), dtype),
        {"penalty": "Penalty", "weakpenalty": "WeakPenalty", "weak": "WeakPenalty",
         "rowelimination": "RowElimination", "rowelim": "RowElimination",
         "rowcolumnelimination": "RowColumnElimination",
         "rowcolumnelim": "RowColumnElimination"}.get(method, "Penalty"),
        pen,
    )
    is_pen = "penalty" in method or "weak" in method
    is_rowcol = "rowcolumn" in method
    A_pre = A  # pre-BC operator (RowColumn per-step correction)
    A_bc, _rhs0 = system.finalized()
    ns = None
    if cfg.solver.preconditioner == "amg":
        from ..solver.amg import rigid_body_modes

        ns = rigid_body_modes(mesh.coords, ndof)
    M_pre = make_precond(A_bc, cfg.solver.preconditioner, nullspace=ns)

    # ---- constant RHS pieces -----------------------------------------------
    g = np.asarray(cfg.gravity[:ndof], np.float64)
    body = jnp.zeros(prob.n_dofs, dtype)
    if np.any(g != 0):
        # ∫ ρ φ_i g_c per node (body-force gauss term,
        # ElastodynamicModule.cc:1893-1899)
        for ct, conn in mesh.cells.items():
            st = gstate.buckets[ct]
            w = jnp.einsum(
                "gc,gi->ci", jnp.asarray(rho_c[ct])[None, :] * st.wdet,
                jnp.asarray(st.N)
            )  # (nc, npc)
            for c in range(ndof):
                if g[c] == 0.0:
                    continue
                dofs = jnp.asarray(prob.dof_ids(conn.reshape(-1), c))
                body = body.at[dofs].add(g[c] * w.reshape(-1))

    # Neumann tractions: constant part now, curves per step — consistent
    # Gauss loads (ops/faces.face_load)
    tr_const = jnp.zeros(prob.n_dofs, dtype)
    tr_timed = []  # (surface entries, curve)
    for nc_ in cfg.neumann:
        entries = []
        for ftype, conn in mesh.face_groups[nc_.surface].items():
            load = F.face_load(ftype, prob.face_xyz(conn), cfg.ninteg)
            entries.append((conn, load))
        if nc_.curve is not None:
            tr_timed.append((entries, nc_.curve))
        else:
            for conn, load in entries:
                for c, tc in enumerate(nc_.t[:ndof]):
                    if tc is None or tc == 0.0:
                        continue
                    dofs = jnp.asarray(prob.dof_ids(conn.reshape(-1), c))
                    tr_const = tr_const.at[dofs].add(tc * load.reshape(-1))

    # double-couple dof sets (ElastodynamicModule.cc:1997-2099)
    dcs = []
    for dc in cfg.double_couple:
        i1, i2 = {0: (0, 1), 1: (1, 2), 2: (0, 2)}[dc.source_plane]
        dcs.append((
            dc,
            jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.west), i2)),
            jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.east), i2)),
            jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.north), i1)),
            jnp.asarray(prob.dof_ids(mesh.group_nodes(dc.south), i1)),
        ))

    # ---- jitted step kernels -------------------------------------------------
    @jax.jit
    def predict(U, V, Acc):
        u_pred = U + dt * V + dt2 * (0.5 - beta) * Acc
        v_pred = V + dt * (1.0 - gamma) * Acc
        rhs = Mm.spmv(cm * u_pred - am * Acc) if am else Mm.spmv(cm * u_pred)
        if af:
            rhs = rhs - af * Km.spmv(U)
        rhs = rhs + body + tr_const
        # paraxial RHS: M_Γ ⊗ P · (c1·u_pred − c0·v_pred − αf·v_n)
        if parax:
            X = (pc1 * u_pred - pc0 * v_pred - af * V).reshape(-1, ndof)
            for _pc, connj, mass, P, _load in parax:
                xf = X[connj]  # (nf, nfn, b)
                contrib = jnp.einsum("fij,fab,fjb->fia", mass, P, xf)
                rhs = rhs.reshape(-1, ndof).at[connj].add(contrib).reshape(-1)
        return rhs, u_pred, v_pred

    @jax.jit
    def apply_bc_rhs(rhs, gdir, fvec):
        rhs = jnp.where(impf, rhs + fvec, rhs)
        if is_pen:
            return jnp.where(dirm, pen * gdir, rhs)
        # row elimination: rhs row = g; rowcol additionally corrects other
        # rows by −A_pre·(g on constrained dofs)
        # (AlephDoFLinearSystem.cc:540-565 semantics, per-step values)
        if is_rowcol:
            gvec = jnp.where(dirm, gdir, 0.0)
            rhs = rhs - A_pre.spmv(gvec)
        return jnp.where(dirm, gdir, rhs)

    @jax.jit
    def update(dU, u_pred, v_pred, a_imp_t, v_imp_t):
        # _updateNewmark with imposed-acceleration/velocity overrides
        # (ElastodynamicModule.cc:567-582)
        a_new = jnp.where(impa, a_imp_t, (dU - u_pred) * cab)
        d_new = jnp.where(impa, u_pred + (beta * dt2) * a_imp_t, dU)
        v_new = jnp.where(impv, v_imp_t, v_pred + dt * gamma * a_new)
        return d_new, v_new, a_new

    # ---- initial state --------------------------------------------------------
    U = jnp.zeros(prob.n_dofs, dtype)
    V = jnp.zeros(prob.n_dofs, dtype)
    Acc = jnp.zeros(prob.n_dofs, dtype)
    Fimp = jnp.zeros(prob.n_dofs, dtype)
    for ic in cfg.init_nodes:  # _applyInitialNodeConditions (:302-327)
        nodes = mesh.group_nodes(ic.node_group)
        for vec_name, vals in (("U", ic.U), ("V", ic.V), ("A", ic.A),
                               ("F", ic.Fv)):
            if vals is None:
                continue
            for c in range(ndof):
                dofs = jnp.asarray(prob.dof_ids(nodes, c))
                val = float(vals[c])
                if vec_name == "U":
                    U = U.at[dofs].set(val)
                elif vec_name == "V":
                    V = V.at[dofs].set(val)
                elif vec_name == "A":
                    Acc = Acc.at[dofs].set(val)
                else:
                    Fimp = Fimp.at[dofs].set(val)

    def eval_channels(kind, vec, t):
        for ch in channels[kind]:
            vec = ch.write(vec, t)
        return vec

    def incident_rhs(rhs, t):
        """Incident-wave traction 2·P(n)·v_in on paraxial faces (extension;
        the reference stores u/v/a_in but never forces with them,
        ElastodynamicModule.cc:2133-2141)."""
        for pc, connj, _mass, P, load in parax:
            if pc.input_type <= 0:
                continue
            vin = _incident_velocity(pc, t, dt, ndof)
            if vin is None:
                continue
            tvec = 2.0 * P @ jnp.asarray(
                np.asarray(vin[:ndof], np.float64)
            )  # (nf, b)
            contrib = jnp.einsum("fi,fa->fia", load, tvec)
            rhs = rhs.reshape(-1, ndof).at[connj].add(contrib).reshape(-1)
        return rhs

    t = cfg.start + dt
    steps = 0
    opts = cfg.solver
    with timer.phase("time-loop"):
        while t <= cfg.tmax + 1e-12 * dt:
            rhs, u_pred, v_pred = predict(U, V, Acc)
            # per-step imposed values at t_{n+1}
            v_imp_t = eval_channels("v", V, t)
            a_imp_t = eval_channels("a", Acc, t)
            Fimp = eval_channels("f", Fimp, t)
            # Dirichlet values: explicit U writes over the integrated state
            # (imposed-acc point rows keep their Newmark-integrated value)
            gdir = eval_channels("u", U, t)
            for entries, curve in tr_timed:
                tv = np.asarray(curve.value(t))
                for conn, load in entries:
                    for c in range(min(ndof, len(tv))):
                        if tv[c] == 0.0:
                            continue
                        dofs = jnp.asarray(prob.dof_ids(conn.reshape(-1), c))
                        rhs = rhs.at[dofs].add(float(tv[c]) * load.reshape(-1))
            if cfg.paraxial_incident:
                rhs = incident_rhs(rhs, t)
            rhs = apply_bc_rhs(rhs, gdir, Fimp)
            for dc, dwest, deast, dnorth, dsouth in dcs:
                ft = _dc_force(dc, t)
                rhs = rhs.at[dwest].set(ft[0]).at[deast].set(-ft[0])
                rhs = rhs.at[dnorth].set(ft[1]).at[dsouth].set(-ft[1])
            x0 = jnp.where(dirm, gdir, U)
            if steps == 0:
                # anchor later steps' absolute tolerance at step one's
                # initial residual (fem/transient.py::anchor_atol)
                opts = replace(
                    cfg.solver,
                    atol=max(cfg.solver.atol,
                             anchor_atol(A_bc, M_pre, rhs, x0, cfg.solver.rtol,
                                         method=cfg.solver.method)),
                )
            dU, info = solve_finalized(A_bc, rhs, opts, x0=x0, precond=M_pre)
            U, V, Acc = update(dU, u_pred, v_pred, a_imp_t, v_imp_t)
            t += dt
            steps += 1

    u = prob.node_values(U)
    res = PassmoResult(
        u=u, v=prob.node_values(V), a=prob.node_values(Acc),
        steps=steps, problem=prob,
    )
    if cfg.recover_fields:
        with timer.phase("stress-strain-recovery"):
            _recover_fields(res, mesh, gstate, prob, U, lam_c, mu_c, cfg)
    if cfg.result_file:
        with timer.phase("result-validation"):
            check_node_results(
                mesh.node_uids, u, cfg.result_file, cfg.result_epsilon,
                min_value=cfg.result_min_value,
            )
    return res


def _paraxial_props(mesh, pc: ParaxialCond, conn, rho_c, vs_c, vp_c):
    """(rho, cs, cp) for a paraxial face bucket — outer-domain options in
    the reference's precedence (E/ν, cp/cs, λ/μ; ElastodynamicModule.cc:
    789-822, with the cs=getCp() slip at :805 fixed), else per-face inner
    boundary-cell values (:838-843)."""
    if pc.E is not None and pc.nu is not None:
        rho = pc.rho if pc.rho is not None else 2500.0
        lam = pc.nu * pc.E / (1 + pc.nu) / (1 - 2 * pc.nu)
        mu = pc.E / 2.0 / (1 + pc.nu)
        return rho, math.sqrt(mu / rho), math.sqrt((lam + 2 * mu) / rho)
    if pc.cp is not None and pc.cs is not None:
        return (pc.rho if pc.rho is not None else 2500.0), pc.cs, pc.cp
    if pc.lam is not None and pc.mu is not None:
        rho = pc.rho if pc.rho is not None else 2500.0
        return rho, math.sqrt(pc.mu / rho), math.sqrt((pc.lam + 2 * pc.mu) / rho)
    # inner: per-face material from the adjacent boundary cell
    adj = F.boundary_cells(mesh, conn)
    rho = np.empty(len(conn))
    cs = np.empty(len(conn))
    cp = np.empty(len(conn))
    for k, a in enumerate(adj):
        if a is None:
            raise ValueError(
                f"paraxial face {k} of '{pc.surface}' has no adjacent cell "
                "and no outer-domain properties were given"
            )
        ct, row = a
        rho[k], cs[k], cp[k] = rho_c[ct][row], vs_c[ct][row], vp_c[ct][row]
    return rho, cs, cp


def _incident_velocity(pc: ParaxialCond, t: float, dt: float, ndof: int):
    """Incident particle velocity (3,) from type-6 curves or the analytic
    input motions (displacement histories differentiated centrally)."""
    if pc.input_type == 6:
        if pc.v_input is not None:
            return np.asarray(pc.v_input.value(t))[:3]
        if pc.u_input is not None:
            up = np.asarray(pc.u_input.value(t + 0.5 * dt))
            um = np.asarray(pc.u_input.value(t - 0.5 * dt))
            return (up - um) / dt
        return None
    # analytic u(t)·direction (ElastodynamicModule.cc:1288-1326)
    def uval(tt):
        return pc.analytic.value(pc.input_type, tt, dt)

    dudt = (uval(t + 0.5 * dt) - uval(t - 0.5 * dt)) / dt
    rad = math.pi / 180.0
    can, san = math.cos(pc.normal_angle * rad), math.sin(pc.normal_angle * rad)
    cat, sat = (math.cos(pc.in_plane_angle * rad),
                math.sin(pc.in_plane_angle * rad))
    if ndof == 3:
        direc = np.array([san * cat, san * sat, can])
    else:
        direc = np.array([san, can, 0.0])
    return dudt * direc


def _dc_force(dc: PassmoDoubleCouple, t: float):
    """(F_eastwest, F_northsouth) at time t (ElastodynamicModule.cc:
    1977-2099: moment → F = M0(t)/distance, loading → F directly)."""
    if dc.moment_table is not None:
        m0 = float(dc.moment_table.value(t)[0])
        few = m0 / dc.dew if dc.dew else m0
        fns = m0 / dc.dns if dc.dns else m0
        return few, fns
    if dc.loading_table is not None:
        ft = float(dc.loading_table.value(t)[0])
        return ft, ft
    return 0.0, 0.0


def _add_face_blocks(prob: FemProblem, A, conn: np.ndarray, blocks):
    """Scatter (nf, nfn, nfn, b, b) face blocks into the BELL matrix."""
    from ..sparse.topology import face_dof_slots

    nfn = conn.shape[1]
    rows = np.repeat(conn, nfn, axis=1).reshape(-1)
    cols = np.tile(conn, (1, nfn)).reshape(-1)
    slots = jnp.asarray(face_dof_slots(prob.topo, rows, cols))
    flat = A.flat_values()
    flat = flat.at[slots].add(blocks.reshape(-1, prob.ndof, prob.ndof))
    return A.with_values(flat)


def _recover_fields(res: PassmoResult, mesh, gstate, prob, U,
                    lam_c, mu_c, cfg: PassmoConfig):
    """Volume-averaged per-cell Voigt strain/stress including the initial
    cell tensors (init-cell-condition) — fills the StrainVol/StrainDev/
    StressVol/StressDev output variables (Elastodynamic.axl:41-52)."""
    ndof = prob.ndof
    sv, sd, tv, td = {}, {}, {}, {}
    # initial tensors per bucket
    eps0 = {ct: np.zeros((c.shape[0], 6)) for ct, c in mesh.cells.items()}
    sig0 = {ct: np.zeros((c.shape[0], 6)) for ct, c in mesh.cells.items()}
    for icc in cfg.init_cells:
        for ct, rows in _group_rows(mesh, icc.cell_group):
            eps0[ct][rows, :3] = icc.vol_strain
            eps0[ct][rows, 3:] = icc.dev_strain
            sig0[ct][rows, :3] = icc.vol_stress
            sig0[ct][rows, 3:] = icc.dev_stress
    for ct, conn in mesh.cells.items():
        st = gstate.buckets[ct]
        eps_g = gstate.strain(ct, conn, U)  # (g, nc, d, d)
        w = st.wdet / jnp.sum(st.wdet, axis=0, keepdims=True)
        eps = np.asarray(jnp.einsum("gc,gcab->cab", w, eps_g))  # (nc, d, d)
        lam = lam_c[ct][:, None, None]
        mu = mu_c[ct][:, None, None]
        tr = np.trace(eps, axis1=1, axis2=2)[:, None, None]
        sig = lam * tr * np.eye(ndof) + 2 * mu * eps
        nc = eps.shape[0]

        def voigt(tmat, t0):
            out = np.zeros((nc, 6))
            for i in range(ndof):
                out[:, i] = tmat[:, i, i]
            out[:, 3] = tmat[:, 0, 1]
            if ndof == 3:
                out[:, 4] = tmat[:, 1, 2]
                out[:, 5] = tmat[:, 0, 2]
            return out + t0

        ev = voigt(eps, eps0[ct])
        sg = voigt(sig, sig0[ct])
        sv[ct], sd[ct] = ev[:, :3], ev[:, 3:]
        tv[ct], td[ct] = sg[:, :3], sg[:, 3:]
    res.strain_vol, res.strain_dev = sv, sd
    res.stress_vol, res.stress_dev = tv, td
    for path, vol, dev in ((cfg.strain_file, sv, sd),
                           (cfg.stress_file, tv, td)):
        if not path:
            continue
        with open(path, "w") as f:
            for ct in sorted(vol):
                for k in range(vol[ct].shape[0]):
                    f.write(
                        f"{ct} {k} "
                        + " ".join(f"{x:.9e}" for x in vol[ct][k])
                        + " " + " ".join(f"{x:.9e}" for x in dev[ct][k])
                        + "\n"
                    )


# --------------------------------------------------------------------------
# .arc case parsing (the Elastodynamic.axl surface)
# --------------------------------------------------------------------------


def _real3(elem, name, default=None):
    from ..fem.arc import opt_text

    txt = opt_text(elem, name)
    if txt is None:
        return default
    vals = [float(x) for x in txt.split()]
    while len(vals) < 3:
        vals.append(vals[-1] if len(vals) == 1 else 0.0)
    return tuple(vals[:3])


def _opt_tuple(elem, names):
    from ..fem.arc import opt_float

    return tuple(opt_float(elem, n) for n in names)


def _curve(case, elem, name, ndim=3):
    import os

    from ..fem.arc import opt_text
    from ..fem.casetable import read_case_table

    fn = opt_text(elem, name)
    if not fn:
        return None
    return read_case_table(os.path.join(case.base_dir, fn), ndim)


def _parse_imposed(case, elem, group_attr, is_surface) -> ImposedCond:
    from ..fem.arc import opt_bool, opt_text

    return ImposedCond(
        group=opt_text(elem, group_attr),
        is_surface=is_surface,
        U=_opt_tuple(elem, ("Ux", "Uy", "Uz")),
        V=_opt_tuple(elem, ("Vx", "Vy", "Vz")),
        A=_opt_tuple(elem, ("Ax", "Ay", "Az")),
        Fv=_opt_tuple(elem, ("Fx", "Fy", "Fz")),
        u_curve=_curve(case, elem, "U-curve"),
        v_curve=_curve(case, elem, "V-curve"),
        a_curve=_curve(case, elem, "A-curve"),
        f_curve=_curve(case, elem, "F-curve"),
        axes=(opt_bool(elem, "x-axis"), opt_bool(elem, "y-axis"),
              opt_bool(elem, "z-axis")),
    )


def config_from_case(case, check: bool = True) -> "PassmoConfig":
    """PassmoConfig from a parsed .arc case (Elastodynamic.axl surface)."""
    from ..fem.arc import opt_float, opt_text

    fem = case.fem
    method = opt_text(fem, "enforce-Dirichlet-method", "Penalty")
    conditions = [
        _parse_imposed(case, d, "surface", True)
        for d in fem.findall("dirichlet-surface-condition")
    ] + [
        _parse_imposed(case, d, "node", False)
        for d in fem.findall("dirichlet-point-condition")
    ]
    neumann = [
        NeumannCond(
            surface=opt_text(n, "surface"),
            t=_opt_tuple(n, ("X-val", "Y-val", "Z-val")),
            curve=_curve(case, n, "curve"),
        )
        for n in fem.findall("neumann-condition")
    ]
    paraxial = []
    for p in fem.findall("paraxial-boundary-condition"):
        paraxial.append(ParaxialCond(
            surface=opt_text(p, "surface"),
            rho=opt_float(p, "rhopar"),
            cs=opt_float(p, "cs"), cp=opt_float(p, "cp"),
            E=opt_float(p, "E-par"), nu=opt_float(p, "nu-par"),
            lam=opt_float(p, "lambda-par"), mu=opt_float(p, "mu-par"),
            input_type=int(opt_float(p, "input-motion-type", 0)),
            analytic=AnalyticInput(
                tp=opt_float(p, "tp", 1.0), ts=opt_float(p, "ts", 1.0),
                coef=opt_float(p, "coef", 1.0),
                amplit=opt_float(p, "amplit", 1.0),
                phase=opt_float(p, "phase", 0.0),
                order=int(opt_float(p, "order", 2)),
            ),
            u_input=_curve(case, p, "u-input"),
            v_input=_curve(case, p, "v-input"),
            a_input=_curve(case, p, "a-input"),
            normal_angle=opt_float(p, "normal-angle", 0.0),
            in_plane_angle=opt_float(p, "in-plane-angle", 0.0),
        ))
    init_props = [
        ElastProps(
            cell_group=opt_text(e, "cell-group"),
            rho=opt_float(e, "rho", 2500.0),
            young=opt_float(e, "young", 0.0), nu=opt_float(e, "nu", 0.0),
            lam=opt_float(e, "lambda", 0.0), mu=opt_float(e, "mu", 0.0),
            vp=opt_float(e, "vp", 0.0), vs=opt_float(e, "vs", 0.0),
        )
        for e in fem.findall("init-elast-properties")
    ]
    init_cells = [
        InitCellCond(
            cell_group=opt_text(e, "cell-group"),
            vol_stress=_real3(e, "vol-stress", (0.0,) * 3),
            vol_strain=_real3(e, "vol-strain", (0.0,) * 3),
            dev_stress=_real3(e, "dev-stress", (0.0,) * 3),
            dev_strain=_real3(e, "dev-strain", (0.0,) * 3),
        )
        for e in fem.findall("init-cell-condition")
    ]
    init_nodes = [
        InitNodeCond(
            node_group=opt_text(e, "node-group"),
            U=_real3(e, "U"), V=_real3(e, "V"), A=_real3(e, "A"),
            Fv=_real3(e, "F"),
        )
        for e in fem.findall("initial-node-condition")
    ]
    dcs = []
    for e in fem.findall("double-couple"):
        dcs.append(PassmoDoubleCouple(
            north=opt_text(e, "north-node"), south=opt_text(e, "south-node"),
            east=opt_text(e, "east-node"), west=opt_text(e, "west-node"),
            source_plane=int(opt_float(e, "source-plane", 0)),
            moment_table=_curve(case, e, "seismic-moment-file", 1),
            loading_table=_curve(case, e, "loading-file", 1),
            dew=opt_float(e, "dist-ew-seismic-moment", 1.0),
            dns=opt_float(e, "dist-ns-seismic-moment", 1.0),
        ))
    init = case.mesh_init
    cfg = PassmoConfig(
        analysis_type=opt_text(fem, "analysis-type", "planestrain"),
        start=opt_float(fem, "start", 0.0),
        tmax=opt_float(fem, "final-time", 1.0),
        dt=opt_float(fem, "deltat", 0.1),
        beta=opt_float(fem, "beta", 0.25),
        gamma=opt_float(fem, "gamma", 0.5),
        alfa_method=opt_text(fem, "alfa_method", "false").lower() == "true",
        alfam=opt_float(fem, "alfam", 0.0),
        alfaf=opt_float(fem, "alfaf", 0.0),
        ninteg=int(opt_float(fem, "gauss-nint", 2)),
        gravity=(opt_float(fem, "gx", 0.0), opt_float(fem, "gy", 0.0),
                 opt_float(fem, "gz", 0.0)),
        rho=dict(init.get("Rho", [])),
        lam=dict(init.get("Lambda", [])),
        mu=dict(init.get("Mu", [])),
        elast_type=opt_text(fem, "init-elast-type", ""),
        init_props=init_props,
        init_cells=init_cells,
        init_nodes=init_nodes,
        conditions=conditions,
        neumann=neumann,
        paraxial=paraxial,
        double_couple=dcs,
        penalty=opt_float(fem, "penalty", 1.0e30),
        method=method,
        solver=case.solver,
        result_file=case.result_file if check else None,
        stress_file=opt_text(fem, "stress-results"),
        strain_file=opt_text(fem, "strain-results"),
    )
    return cfg


def _run_arc(case, mesh, dtype=np.float64, check: bool = True, timer=None):
    cfg = config_from_case(case, check=check)
    return solve(mesh, cfg, dtype=dtype, timer=timer)


def _register():
    from ..fem.runner import register

    register("Passmo")(_run_arc)


_register()
