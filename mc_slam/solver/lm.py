"""Levenberg-Marquardt engine with dense-block Schur complement — the batched
device replacement for the reference's vendored g2o (Thirdparty/g2o: sparse_optimizer,
block_solver with landmark Schur marginalization, optimization_algorithm_levenberg,
linear_solver_eigen/cholmod).

Design (accelerator-first, see SURVEY.md section 7 step 4):
* The camera system is DENSE: H_cc lives as (Nc, DC, Nc, DC). SLAM camera counts
  (local window ~25, global a few hundred) make the reduced system a small dense
  matrix that XLA Cholesky eats for free; sparsity tricks that pay on CPUs are
  anti-patterns for batched matrix hardware.
* Landmarks are Schur-marginalized with batched 3x3 (or 1x1 inverse-depth) block
  inverses and ONE big matmul for the camera-camera correction — this is the term
  that later shards across devices (landmark chunks per device + psum).
* Robustness: Huber IRLS weights folded into per-observation information.
* Fixed vertices: a free-mask zeroes their Jacobian columns and the reduced system
  gets identity rows on their blocks, so one code path serves all gauge choices.
* The LM loop is a fixed-iteration jitted loop: one linearization per iteration,
  candidate accepted by strict cost decrease (NaN-safe: NaN candidates reject and
  raise lambda), matching the reference's fixed 4x10-iteration usage pattern
  (src/Optimizer.cpp:1920-1980) without data-dependent Python control flow.
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp


def huber_weight(chi2, delta_sq):
    """IRLS weight for the Huber kernel on squared error chi2 (g2o RobustKernelHuber):
    w = 1 for chi2 <= delta^2 else delta/sqrt(chi2)."""
    safe = jnp.maximum(chi2, 1e-12)
    return jnp.where(chi2 <= delta_sq, jnp.ones_like(chi2), jnp.sqrt(delta_sq / safe))


def huber_cost(chi2, delta_sq):
    """rho(chi2): chi2 below the knee, 2*delta*sqrt(chi2) - delta^2 above."""
    safe = jnp.maximum(chi2, 1e-12)
    return jnp.where(chi2 <= delta_sq, chi2, 2.0 * jnp.sqrt(delta_sq * safe) - delta_sq)


# Truncation point of the robust kernel for reprojection residuals, as a
# multiple of the Huber knee delta^2 (chi2 = 400*delta^2 ~ a 49 px error at
# sigma(level 0)). Two constraints pick this value:
#   * Without truncation a plain Huber grows unboundedly (2*delta*sqrt(chi2))
#     while any finite behind-camera penalty is flat, so Schur BA can strictly
#     LOWER its cost by pushing a contested landmark behind an outlier
#     observer — observed as hundreds of points teleporting multiple map-units
#     in one local-BA call when the window contains inconsistent (drifted)
#     observation epochs. Setting the behind-camera penalty EQUAL to the
#     truncation plateau (trunc_plateau below) makes "out of the frustum"
#     never cheaper than any in-view residual, closing the escape exactly.
#   * A tight truncation (e.g. 6.25*delta^2 = the classic outlier gate)
#     destroys the convergence basin: a merely-perturbed initialization with
#     ~10 px residuals gets zero gradient and LM stalls. 400*delta^2 keeps
#     the full Huber pull for everything a sane initialization produces and
#     zeroes only certain association errors.
# The reference is immune to both by different means: plain Huber plus
# DELETING chi2>5.991 edges between optimization rounds
# (src/Optimizer.cpp:1920-1980; LocalMapping erases outlier observations).
# Truncation is the jit-friendly equivalent of the deletion phase.
HUBER_TRUNC = 400.0


def trunc_plateau(delta_sq):
    """Cost plateau of the truncated kernel == huber_cost(HUBER_TRUNC*d2, d2).

    Also the behind-camera penalty everywhere: in-view always costs <= this."""
    return (2.0 * jnp.sqrt(HUBER_TRUNC) - 1.0) * delta_sq


def trunc_huber_cost(chi2, delta_sq):
    """Truncated Huber rho: huber(chi2) below HUBER_TRUNC*delta^2, flat above."""
    return jnp.minimum(huber_cost(chi2, delta_sq), trunc_plateau(delta_sq))


def trunc_huber_weight(chi2, delta_sq):
    """IRLS weight of the truncated kernel: huber weight inside, 0 beyond,
    with a linear ramp over the last 30% so the weight is CONTINUOUS in chi2
    — a hard cutoff makes the step direction discontinuous in the residuals,
    which float reduction-order noise then amplifies into visible
    sharded-vs-single-device divergence for boundary observations."""
    T = HUBER_TRUNC * delta_sq
    ramp = jnp.clip((T - chi2) / (0.3 * T), 0.0, 1.0)
    return huber_weight(chi2, delta_sq) * ramp


class Observations(NamedTuple):
    """A batch of landmark-observation factors with up to K camera blocks each.

    K = 1 for plain XYZ reprojection, K = 2 for anchored inverse-depth (anchor +
    observer). All arrays are padded to fixed shapes; `w` == 0 disables an entry.
    """
    cam: jnp.ndarray    # (O, K) int32 camera indices
    pt: jnp.ndarray     # (O,)   int32 landmark indices
    Jc: jnp.ndarray     # (O, K, R, DC) camera Jacobian blocks (R = residual dim)
    Jp: jnp.ndarray     # (O, R, DP) landmark Jacobian
    r: jnp.ndarray      # (O, R) residuals
    w: jnp.ndarray      # (O,) scalar weight (info * robust * valid); isotropic info


class CamFactors(NamedTuple):
    """Camera-only factors (IMU chain, bias RW, priors, pose-graph edges) with up
    to K camera blocks and a full RxR information matrix each."""
    cam: jnp.ndarray    # (F, K) int32
    J: jnp.ndarray      # (F, K, R, DC)
    r: jnp.ndarray      # (F, R)
    info: jnp.ndarray   # (F, R, R)
    w: jnp.ndarray      # (F,) robust/valid scalar


def _apply_free_mask(J, cam, free_mask):
    """Zero Jacobian blocks of fixed cameras. J: (..., K, R, DC), cam: (..., K)."""
    m = free_mask[cam]  # (..., K)
    return J * m[..., None, None]


def accumulate_cam_factors(H, g, cost, fac: CamFactors, free_mask):
    """Scatter camera-only factors into the dense camera system.

    H: (Nc, DC, Nc, DC), g: (Nc, DC). Returns updated (H, g, cost).
    """
    J = _apply_free_mask(fac.J, fac.cam, free_mask)
    wInfo = fac.info * fac.w[..., None, None]              # (F, R, R)
    # cost uses the UNMASKED residual (fixed cams still contribute error)
    cost = cost + jnp.sum(fac.w * jnp.einsum('fr,frs,fs->f', fac.r, fac.info, fac.r))
    JtW = jnp.einsum('fkrc,frs->fksc', J, wInfo)           # (F, K, R->s?, ...) J^T W
    g_blocks = jnp.einsum('fksc,fs->fkc', JtW, fac.r)      # (F, K, DC)
    H_blocks = jnp.einsum('fksc,flsd->fklcd', JtW, J)      # (F, K, K, DC, DC)
    K = fac.cam.shape[-1]
    g = g.at[fac.cam.reshape(-1)].add(g_blocks.reshape(-1, g.shape[-1]))
    ca = jnp.repeat(fac.cam, K, axis=-1).reshape(-1)       # (F*K*K,) row cam
    cb = jnp.tile(fac.cam, (1, K)).reshape(-1)             # (F*K*K,) col cam
    H = H.at[ca, :, cb, :].add(H_blocks.reshape(-1, H.shape[1], H.shape[3]))
    return H, g, cost


def build_landmark_system(obs: Observations, free_mask, Nc, DC, Np, DP):
    """Accumulate reprojection factors into (H_cc, g_c) plus the landmark-side
    blocks needed for Schur: Hpp (Np,DP,DP), g_p (Np,DP), Wcp (Nc,DC,Np,DP), cost.
    """
    dtype = obs.r.dtype
    Jc = _apply_free_mask(obs.Jc, obs.cam, free_mask)       # (O,K,R,DC)
    w = obs.w                                               # (O,)
    cost = jnp.sum(w * jnp.sum(obs.r * obs.r, axis=-1))

    wJp = obs.Jp * w[..., None, None]                       # (O,R,DP)
    Hpp = jnp.zeros((Np, DP, DP), dtype).at[obs.pt].add(
        jnp.einsum('ord,ore->ode', wJp, obs.Jp))
    g_p = jnp.zeros((Np, DP), dtype).at[obs.pt].add(
        jnp.einsum('ord,or->od', wJp, obs.r))

    wJc = Jc * w[..., None, None, None]                     # (O,K,R,DC)

    # Camera system via the dense G-matrix: G[o,r,:] is the obs Jacobian row
    # scattered into the (Nc*DC)-wide camera state. Hcc = (wG)^T G is then ONE
    # matmul — the per-obs (K,K,DC,DC) block outer products + scatter-add it
    # replaces lowered to a pathological conv fusion.
    O, K, R, _ = Jc.shape
    onehot = (obs.cam[..., None] == jnp.arange(Nc)[None, None, :]).astype(dtype)
    G = jnp.einsum('okc,okrj->orcj', onehot, Jc).reshape(O, R, Nc * DC)
    wG = jnp.einsum('okc,okrj->orcj', onehot, wJc).reshape(O, R, Nc * DC)
    Hcc = jnp.einsum('orm,orn->mn', wG, G).reshape(Nc, DC, Nc, DC)
    g_c = jnp.einsum('orm,or->m', wG, obs.r).reshape(Nc, DC)

    Wcp_blocks = jnp.einsum('okrc,ord->okcd', wJc, obs.Jp)    # (O,K,DC,DP)
    Wcp = jnp.zeros((Nc, DC, Np, DP), dtype).at[
        obs.cam.reshape(-1), :, jnp.repeat(obs.pt[:, None], K, axis=-1).reshape(-1), :
    ].add(Wcp_blocks.reshape(-1, DC, DP))
    return Hcc, g_c, Hpp, g_p, Wcp, cost


def batched_inv_small(H):
    """Closed-form inverse for batched 1x1/2x2/3x3 SPD blocks.

    jnp.linalg.inv lowers to a LAPACK-style custom call per batch; the
    adjugate form is pure elementwise arithmetic that XLA fuses."""
    d = H.shape[-1]
    if d == 1:
        return 1.0 / H
    if d == 2:
        a, b = H[..., 0, 0], H[..., 0, 1]
        c, e = H[..., 1, 0], H[..., 1, 1]
        det = a * e - b * c
        inv_det = 1.0 / det
        return jnp.stack([
            jnp.stack([e, -b], -1),
            jnp.stack([-c, a], -1)], -2) * inv_det[..., None, None]
    if d == 3:
        a, b, c = H[..., 0, 0], H[..., 0, 1], H[..., 0, 2]
        d2, e, f = H[..., 1, 0], H[..., 1, 1], H[..., 1, 2]
        g, h, i = H[..., 2, 0], H[..., 2, 1], H[..., 2, 2]
        A = e * i - f * h
        B = f * g - d2 * i
        C = d2 * h - e * g
        det = a * A + b * B + c * C
        inv_det = 1.0 / det
        adj = jnp.stack([
            jnp.stack([A, c * h - b * i, b * f - c * e], -1),
            jnp.stack([B, a * i - c * g, c * d2 - a * f], -1),
            jnp.stack([C, b * g - a * h, a * e - b * d2], -1)], -2)
        return adj * inv_det[..., None, None]
    return jnp.linalg.inv(H)


def damp_point_blocks(Hpp, lam):
    """LM-damp landmark blocks: multiplicative on the diagonal plus an
    absolute floor SCALED TO THE PROBLEM (mean per-point diagonal energy of
    the observed landmarks). Multiplicative-only damping leaves near-nullspace
    directions (landmark depth under low parallax: Hpp eigenvalue ~ 0)
    essentially undamped, and single LM steps can slide points many map-units
    along their rays; a fixed 1e-8 floor is invisible at typical reprojection-
    information scales (~1e4). 1e-3 x mean diag bounds the step along a
    zero-curvature direction to ~1000x the well-conditioned step — finite,
    and tightening as lambda rises on rejection."""
    DP = Hpp.shape[-1]
    eyep = jnp.eye(DP, dtype=Hpp.dtype)
    d_pt = jnp.sum(jnp.diagonal(Hpp, axis1=-2, axis2=-1), -1)
    d_avg = jnp.sum(d_pt) / jnp.maximum(jnp.sum(d_pt > 0), 1)
    floor = jnp.maximum(1e-3 * d_avg * lam, 1e-8)
    return Hpp + lam * (Hpp * eyep) + floor * eyep


def schur_solve(Hcc, g_c, Hpp, g_p, Wcp, lam, free_mask, pt_mask):
    """Damped Schur solve. Returns (dxc (Nc,DC), dxp (Np,DP)).

    lam: LM damping (scalar). Fixed cameras get identity blocks; empty landmarks
    are masked out of the back-substitution.
    """
    Nc, DC, Np, DP = Wcp.shape
    dtype = Hcc.dtype
    # damp landmark blocks: multiplicative on the diagonal plus an absolute
    # floor SCALED TO THE PROBLEM (median of the per-point diagonal energy).
    # Multiplicative-only damping leaves near-nullspace directions (landmark
    # depth under low parallax: Hpp eigenvalue ~ 0) essentially undamped, and
    # single LM steps can slide points many map-units along their rays; a
    # fixed 1e-8 floor is invisible at typical reprojection-information
    # scales (~1e4). 1e-3 x median diag bounds the step along a direction
    # with zero curvature to ~1000x the well-conditioned step — finite, and
    # tightening as lambda rises on rejection.
    Hpp_inv = batched_inv_small(damp_point_blocks(Hpp, lam))

    Y = jnp.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)           # (Nc,DC,Np,DP)
    # reduced camera system
    S = Hcc - jnp.einsum('cipk,djpk->cidj', Y, Wcp)          # big matmul
    g_s = g_c - jnp.einsum('cipk,pk->ci', Y, g_p)

    # camera damping: multiplicative on the diagonal of Hcc
    n = Nc * DC
    Sf = S.reshape(n, n)
    diag_c = jnp.diagonal(Hcc.reshape(n, n))
    Sf = Sf + jnp.diag(lam * diag_c + 1e-10)
    # fixed cameras: identity row/col
    fm = jnp.repeat(free_mask, DC)
    Sf = Sf * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    g_sf = g_s.reshape(n) * fm

    L, low = jax.scipy.linalg.cho_factor(Sf, lower=True)
    dxc = jax.scipy.linalg.cho_solve((L, low), -g_sf).reshape(Nc, DC)

    # back-substitute landmarks: dxp = -Hpp_inv (g_p + Wcp^T dxc)
    rhs = g_p + jnp.einsum('cipj,ci->pj', Wcp, dxc)
    dxp = -jnp.einsum('pjk,pk->pj', Hpp_inv, rhs)
    dxp = dxp * pt_mask[:, None]
    return dxc, dxp


def solve_cam_system(H, g, lam, free_mask):
    """Plain damped solve of a camera-only system (pose-only optim, pose graph)."""
    Nc, DC = g.shape
    n = Nc * DC
    Hf = H.reshape(n, n)
    diag = jnp.diagonal(Hf)
    Hf = Hf + jnp.diag(lam * diag + 1e-10)
    fm = jnp.repeat(free_mask, DC)
    Hf = Hf * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    L, low = jax.scipy.linalg.cho_factor(Hf, lower=True)
    return jax.scipy.linalg.cho_solve((L, low), -(g.reshape(n) * fm)).reshape(Nc, DC)


class LMState(NamedTuple):
    x: object          # pytree of optimized variables
    lam: jnp.ndarray
    cost: jnp.ndarray


def lm_optimize(x0, linearize_solve: Callable, retract: Callable, cost_fn: Callable,
                iters: int, lam0=1e-4, lam_down=0.5, lam_up=4.0, lam_min=1e-9,
                lam_max=1e6, rtol=0.0):
    """Generic fixed-iteration LM driver (jit-friendly).

    linearize_solve(x, lam) -> dx  : builds normal equations at x and solves.
    retract(x, dx) -> x'           : applies the update on the manifold.
    cost_fn(x) -> scalar           : robust total cost.
    rtol > 0 enables early termination (the synchronous analog of the
    reference's mbAbortBA iteration budget, src/LocalMapping.cpp:1112): once an
    accepted step improves cost by less than rtol relative, remaining scan
    iterations take the cheap no-op branch of a lax.cond.
    """
    c0 = cost_fn(x0)

    def work(st: LMState):
        dx = linearize_solve(st.x, st.lam)
        x_new = retract(st.x, dx)
        c_new = cost_fn(x_new)
        # candidate must BOTH lower the cost and be entirely finite: behind-
        # camera masking in robust costs can swallow NaN states into finite
        # saturated costs, so a NaN-poisoned solve could otherwise be accepted
        finite = jnp.asarray(True)
        for leaf in jax.tree_util.tree_leaves(x_new):
            finite = finite & jnp.all(jnp.isfinite(leaf))
        accept = (c_new < st.cost) & finite
        x = jax.tree_util.tree_map(lambda a, b: jnp.where(accept, b, a), st.x, x_new)
        lam = jnp.clip(jnp.where(accept, st.lam * lam_down, st.lam * lam_up), lam_min, lam_max)
        cost = jnp.where(accept, c_new, st.cost)
        done = accept & (st.cost - cost < rtol * jnp.maximum(st.cost, 1e-12))
        return LMState(x, lam, cost), done

    if rtol > 0.0:
        def step(carry, _):
            st, done = carry
            st2, done2 = jax.lax.cond(done, lambda s: (s, jnp.asarray(True)),
                                      work, st)
            return (st2, done | done2), st2.cost
        init = (LMState(x0, jnp.asarray(lam0, c0.dtype), c0), jnp.asarray(False))
        (final, _), costs = jax.lax.scan(step, init, None, length=iters)
    else:
        def step(st, _):
            st2, _ = work(st)
            return st2, st2.cost
        init = LMState(x0, jnp.asarray(lam0, c0.dtype), c0)
        final, costs = jax.lax.scan(step, init, None, length=iters)
    return final.x, final.cost, costs


def lm_optimize_fused(x0, linearize, solve, retract, iters: int,
                      lam0=1e-4, lam_down=0.5, lam_up=4.0, lam_min=1e-9,
                      lam_max=1e6, rtol=0.0):
    """LM driver that REUSES the linearization for the accept/reject cost:
    `linearize(x) -> (lin, cost)` builds the normal-equation blocks AND the
    robust cost in one pass; `solve(lin, lam) -> dx`. A rejected candidate
    re-raises lambda and re-solves from the CARRIED linearization instead of
    re-linearizing — per iteration this runs ONE residual/Jacobian pass where
    the classic driver (lm_optimize) runs two (linearize_solve + cost_fn).
    On a 20-KF IDP window the residual pass is ~2/3 of the iteration, so this
    is ~1.6x per-iteration throughput at identical accepted-step math.
    rtol > 0 enables early termination exactly as in lm_optimize: once an
    accepted step improves cost by less than rtol relative, remaining scan
    iterations take the cheap no-op branch."""
    lin0, c0 = linearize(x0)

    def work(st):
        x, lin, cost, lam = st
        dx = solve(lin, lam)
        x_new = retract(x, dx)
        lin_new, c_new = linearize(x_new)
        finite = jnp.asarray(True)
        for leaf in jax.tree_util.tree_leaves(x_new):
            finite = finite & jnp.all(jnp.isfinite(leaf))
        accept = (c_new < cost) & finite
        sel = lambda a, b: jax.tree_util.tree_map(
            lambda u, v: jnp.where(accept, v, u), a, b)
        x2 = sel(x, x_new)
        lin2 = sel(lin, lin_new)
        cost2 = jnp.where(accept, c_new, cost)
        lam2 = jnp.clip(jnp.where(accept, lam * lam_down, lam * lam_up),
                        lam_min, lam_max)
        done = accept & (cost - cost2 < rtol * jnp.maximum(cost, 1e-12))
        return (x2, lin2, cost2, lam2), done

    if rtol > 0.0:
        def step(carry, _):
            st, done = carry
            st2, done2 = jax.lax.cond(
                done, lambda s: (s, jnp.asarray(True)), work, st)
            return (st2, done | done2), st2[2]
        init = ((x0, lin0, c0, jnp.asarray(lam0, c0.dtype)),
                jnp.asarray(False))
        ((x, _, cost, _), _), costs = jax.lax.scan(step, init, None,
                                                   length=iters)
    else:
        def step(st, _):
            st2, _ = work(st)
            return st2, st2[2]
        init = (x0, lin0, c0, jnp.asarray(lam0, c0.dtype))
        (x, _, cost, _), costs = jax.lax.scan(step, init, None, length=iters)
    return x, cost, costs


def lm_two_phase(x0, make_fns, valid0, classify, iters: int, p1_frac=0.4,
                 rtol=0.0, lam0=1e-4, enable=True):
    """Two-round LM with inlier re-classification between rounds — the
    reference's optimization protocol (src/Optimizer.cpp:1920-1980: rounds of
    LM re-classifying chi2>5.991 edges as outliers between rounds;
    LocalBundleAdjustment:3858 removes them before the second pass).

    make_fns(valid) -> (linearize_solve, retract, cost_fn) closures using the
    given per-observation validity. classify(x, valid0) -> the phase-2
    validity (re-classification starts from valid0, so a phase-1 outlier that
    recovered is re-included, as in the reference).

    This is the structural fix for contested windows (inconsistent
    observation epochs after drift or a loop correction): round 1 pulls the
    state into the dominant consensus under the full robust kernel, round 2
    removes everything that consensus calls an outlier so it cannot drag
    landmarks into compromise positions. The truncated kernel (HUBER_TRUNC)
    stays active in both rounds as the safety net for gross outliers.

    The round structure mirrors the reference EXACTLY where it exists:
    pose-only tracking re-classifies between rounds
    (src/Optimizer.cpp:1920-1980) and the local window BA deletes outliers
    before a second pass (src/Optimizer.cpp:3858) — but the reference's
    GLOBAL BA is a single Huber run with no outlier round
    (src/Optimizer.cpp:3346/:629), so GBA-type callers pass enable=False.
    rtol > 0 additionally means the caller is running in the reference's
    ABORTABLE-BA mode (mbAbortBA, src/LocalMapping.cpp:1112: the background
    local BA is torn down as soon as new work arrives, usually before its
    outlier round) — only round 1 runs there too.
    """
    if not enable or rtol > 0.0:
        ls1, rt1, cf1 = make_fns(valid0)
        return lm_optimize(x0, ls1, rt1, cf1, iters, rtol=rtol, lam0=lam0)
    it1 = max(2, int(round(iters * p1_frac)))
    it2 = max(2, iters - it1)
    ls1, rt1, cf1 = make_fns(valid0)
    x1, _, _ = lm_optimize(x0, ls1, rt1, cf1, it1, rtol=rtol, lam0=lam0)
    valid2 = classify(x1, valid0)
    ls2, rt2, cf2 = make_fns(valid2)
    return lm_optimize(x1, ls2, rt2, cf2, it2, rtol=rtol, lam0=lam0)


def schur_solve_pr(Hcc, g_c, Hpp, g_p, Wcp, lam, free_mask, pt_mask):
    """Damped Schur solve for VI systems where landmarks couple ONLY to the
    leading Dv (pose) columns of each DC-dim camera block.

    Reprojection factors touch [dP, dphi] but not [dV, dbg, dba]; building
    their blocks in 6-d and embedding here cuts the Hcc outer products ~6x
    and the Wcp/Schur work ~2.5x vs padding Jacobians to 15 columns.

    Hcc: (Nc, DC, Nc, DC) FULL camera system (visual 6-d part already embedded
    by the caller). Wcp: (Nc, Dv, Np, DP). Returns (dxc (Nc,DC), dxp (Np,DP)).
    """
    Nc, Dv, Np, DP = Wcp.shape
    DC = g_c.shape[-1]
    dtype = Hcc.dtype
    Hpp_inv = batched_inv_small(damp_point_blocks(Hpp, lam))

    Y = jnp.einsum('cipj,pjk->cipk', Wcp, Hpp_inv)           # (Nc,Dv,Np,DP)
    S_corr = jnp.einsum('cipk,djpk->cidj', Y, Wcp)           # (Nc,Dv,Nc,Dv)
    g_corr = jnp.einsum('cipk,pk->ci', Y, g_p)               # (Nc,Dv)
    S = Hcc.at[:, :Dv, :, :Dv].add(-S_corr)
    g_s = g_c.at[:, :Dv].add(-g_corr)

    n = Nc * DC
    Sf = S.reshape(n, n)
    diag_c = jnp.diagonal(Hcc.reshape(n, n))
    Sf = Sf + jnp.diag(lam * diag_c + 1e-10)
    fm = jnp.repeat(free_mask, DC)
    Sf = Sf * fm[:, None] * fm[None, :] + jnp.diag(1.0 - fm)
    L, low = jax.scipy.linalg.cho_factor(Sf, lower=True)
    dxc = jax.scipy.linalg.cho_solve((L, low), -(g_s.reshape(n) * fm)).reshape(Nc, DC)

    rhs = g_p + jnp.einsum('cipj,ci->pj', Wcp, dxc[:, :Dv])
    dxp = -jnp.einsum('pjk,pk->pj', Hpp_inv, rhs)
    return dxc, dxp * pt_mask[:, None]
