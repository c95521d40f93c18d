"""Non-exponential free-flight transmittance laws (Bitterli et al. 2018
framework), batched over media (port of
tungsten_tpu/media/transmittance.py).

Four-kernel interface parity with ref src/core/transmittances/
Transmittance.hpp:49-57: surfaceSurface / surfaceMedium / mediumSurface /
mediumMedium over optical depth tau, plus sigmaBar and the two samplers.
Laws: exponential, double_exponential, linear, quadratic, erlang, davis,
davis_weinstein, pulse, interpolated (ref TransmittanceFactory.cpp:15-25).

Params layout (med_trans_params (M,4), widened to (M,16) only when a
scene uses `interpolated`; the wrappers read the width, so scenes
without it pay nothing):
  exponential:        -
  linear/quadratic:   [max_t]
  double_exponential: [sigma_a, sigma_b]
  erlang:             [lambda]
  davis:              [alpha]
  davis_weinstein:    [h, c]
  pulse:              [a, b, num_pulses]
  interpolated:       cols [4]=type_a [5]=type_b [6]=ratio
                      [8:12]=params_a [12:16]=params_b
                      (ref InterpolatedTransmittance.cpp: lerp of two
                      child laws; children are never interpolated)

Every public function takes `laws`, the law ids to dispatch over (those
present in the scene, children of interpolated rows included; see
`present_laws`); None dispatches over all nine.  A lane whose law is not
in `laws` gets the exponential law's value, as it would any unknown id.
"""
from __future__ import annotations

import torch

from tungsten_tpu_torch.utils.vecmath import clip

T_EXPONENTIAL = 0
T_DOUBLE_EXPONENTIAL = 1
T_LINEAR = 2
T_QUADRATIC = 3
T_ERLANG = 4
T_DAVIS = 5
T_DAVIS_WEINSTEIN = 6
T_PULSE = 7
T_INTERPOLATED = 8

NAMES = {
    "exponential": T_EXPONENTIAL,
    "double_exponential": T_DOUBLE_EXPONENTIAL,
    "linear": T_LINEAR,
    "quadratic": T_QUADRATIC,
    "erlang": T_ERLANG,
    "davis": T_DAVIS,
    "davis_weinstein": T_DAVIS_WEINSTEIN,
    "pulse": T_PULSE,
    "interpolated": T_INTERPOLATED,
}

# laws whose mediumMedium is a dirac / sum of diracs (ref
# LinearTransmittance.cpp:65, PulseTransmittance.cpp:39)
_DIRAC_LAWS = (T_LINEAR, T_PULSE)

MAX_PULSES = 8  # static unroll bound for pulse sampling


def present_laws(trans_type, trans_params) -> tuple:
    """The law ids a medium table uses, the children of interpolated rows
    included (host ints; one device read)."""
    tt = trans_type.tolist()
    laws = set(int(t) for t in tt) | {T_EXPONENTIAL}
    if trans_params.shape[-1] >= 16 and T_INTERPOLATED in laws:
        kids = trans_params[:, 4:6].tolist()
        laws |= {int(k) for row, t in zip(kids, tt)
                 if t == T_INTERPOLATED for k in row}
    return tuple(sorted(laws))


def _has(laws, law) -> bool:
    return laws is None or law in laws


def _interp_parts(p):
    """Child (type, params, ratio) columns of an interpolated row."""
    ta = p[..., 4].to(torch.int32)
    tb = p[..., 5].to(torch.int32)
    u = p[..., 6:7]
    return ta, tb, u, p[..., 8:12], p[..., 12:16]


def _pulse_cell(tau, a, b, n):
    return torch.clamp(n * (tau - a) / torch.clamp(b - a, min=1e-20),
                       min=0.0).minimum(n)


def _dispatch(ttype, tau, p, fns, laws):
    out = torch.zeros_like(tau)
    for tid, fn in fns.items():
        if _has(laws, tid):
            out = torch.where(ttype[..., None] == tid, fn(tau, p), out)
    return out


def _dw_alpha(tau, p):
    h, c = p[..., 0:1], p[..., 1:2]
    beta = 2.0 * h - 1.0
    t = torch.clamp(tau, min=1e-20)
    return beta, t, torch.pow(t, 1.0 - beta) / torch.pow(c, 1.0 + beta)


def _surface_surface_base(ttype, tau, p, laws):
    def exp_(tau, p):
        return torch.exp(-tau)

    def dexp(tau, p):
        sa, sb = p[..., 0:1], p[..., 1:2]
        return 0.5 * (torch.exp(-sa * tau) + torch.exp(-sb * tau))

    def lin(tau, p):
        return 1.0 - clip(tau / p[..., 0:1], hi=1.0)

    def quad(tau, p):
        t = clip(tau / p[..., 0:1], hi=1.0)
        return 1.0 - 2.0 * t + t * t

    def erl(tau, p):
        lam = p[..., 0:1]
        return 0.5 * torch.exp(-lam * tau) * (2.0 + lam * tau)

    def davis(tau, p):
        al = p[..., 0:1]
        return torch.pow(1.0 + tau / al, -al)

    def dw(tau, p):
        _, _, al = _dw_alpha(tau, p)
        tr = torch.pow(1.0 + tau / torch.clamp(al, min=1e-20), -al)
        return torch.where(torch.isfinite(tr), tr, 0.0)

    def pulse(tau, p):
        a, b, n = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        idxf = torch.clamp(n * (tau - a) / torch.clamp(b - a, min=1e-20)
                           + 0.5, min=0.0).minimum(n)
        idx = torch.floor(idxf)
        height = (n - idx) / n
        cell = height * (idxf - idx)
        extra = torch.where(idx > 0,
                            (idx - 0.5) - (idx * (idx - 1.0)) / (2.0 * n),
                            -0.5)
        cell = cell + extra
        return 1.0 - (2.0 / n) * cell

    return _dispatch(ttype, tau, p, {
        T_EXPONENTIAL: exp_, T_DOUBLE_EXPONENTIAL: dexp, T_LINEAR: lin,
        T_QUADRATIC: quad, T_ERLANG: erl, T_DAVIS: davis,
        T_DAVIS_WEINSTEIN: dw, T_PULSE: pulse}, laws)


def _dw_surface_medium(tau, p):
    beta, t, al = _dw_alpha(tau, p)
    base = 1.0 + t / al
    trs = torch.pow(base, -al)
    tr = trs * (beta / base - (beta - 1.0) * al / t * torch.log(base))
    return torch.where(torch.isfinite(tr), tr, 0.0)


def _pulse_medium_surface(tau, p):
    a, b, n = p[..., 0:1], p[..., 1:2], p[..., 2:3]
    idx = torch.clamp(torch.floor(n * (tau - a) / torch.clamp(b - a, min=1e-20)
                                  + 0.5), min=0.0).minimum(n)
    return 1.0 - idx / n


def _surface_medium_base(ttype, tau, p, laws):
    def exp_(tau, p):
        return torch.exp(-tau)

    def dexp(tau, p):
        sa, sb = p[..., 0:1], p[..., 1:2]
        return 0.5 * (sa * torch.exp(-sa * tau) + sb * torch.exp(-sb * tau))

    def lin(tau, p):
        mt = p[..., 0:1]
        return torch.where(tau > mt, 0.0, 1.0 / mt)

    def quad(tau, p):
        mt = p[..., 0:1]
        return (2.0 / mt) * (1.0 - clip(tau / mt, hi=1.0))

    def erl(tau, p):
        lam = p[..., 0:1]
        return torch.exp(-lam * tau) * (1.0 + lam * tau) * lam * 0.5

    def davis(tau, p):
        al = p[..., 0:1]
        return torch.pow(1.0 + tau / al, -(al + 1.0))

    def pulse(tau, p):
        a, b = p[..., 0:1], p[..., 1:2]
        return 2.0 / (b - a) * _pulse_medium_surface(tau, p)

    return _dispatch(ttype, tau, p, {
        T_EXPONENTIAL: exp_, T_DOUBLE_EXPONENTIAL: dexp, T_LINEAR: lin,
        T_QUADRATIC: quad, T_ERLANG: erl, T_DAVIS: davis,
        T_DAVIS_WEINSTEIN: _dw_surface_medium, T_PULSE: pulse}, laws)


def _medium_surface_base(ttype, tau, p, laws):
    def exp_(tau, p):
        return torch.exp(-tau)

    def dexp(tau, p):
        sa, sb = p[..., 0:1], p[..., 1:2]
        return (sa * torch.exp(-sa * tau) + sb * torch.exp(-sb * tau)) / \
            (sa + sb)

    def lin(tau, p):
        return torch.where(tau > p[..., 0:1], 0.0, 1.0)

    def quad(tau, p):
        return 1.0 - clip(tau / p[..., 0:1], hi=1.0)

    def erl(tau, p):
        lam = p[..., 0:1]
        return torch.exp(-lam * tau) * (1.0 + lam * tau)

    def davis(tau, p):
        al = p[..., 0:1]
        return torch.pow(1.0 + tau / al, -(al + 1.0))

    # davis_weinstein mediumSurface == surfaceMedium
    return _dispatch(ttype, tau, p, {
        T_EXPONENTIAL: exp_, T_DOUBLE_EXPONENTIAL: dexp, T_LINEAR: lin,
        T_QUADRATIC: quad, T_ERLANG: erl, T_DAVIS: davis,
        T_PULSE: _pulse_medium_surface,
        T_DAVIS_WEINSTEIN: _dw_surface_medium}, laws)


def _medium_medium_base(ttype, tau, p, laws):
    def exp_(tau, p):
        return torch.exp(-tau)

    def dexp(tau, p):
        sa, sb = p[..., 0:1], p[..., 1:2]
        return (sa * sa * torch.exp(-sa * tau)
                + sb * sb * torch.exp(-sb * tau)) / (sa + sb)

    def lin(tau, p):
        mt = p[..., 0:1]
        return torch.where(torch.abs(tau - mt) < 1e-3, 1.0, 0.0)

    def quad(tau, p):
        mt = p[..., 0:1]
        return torch.where(tau > mt, 0.0, 1.0 / mt)

    def erl(tau, p):
        lam = p[..., 0:1]
        return lam * lam * tau * torch.exp(-lam * tau)

    def davis(tau, p):
        al = p[..., 0:1]
        return (1.0 + 1.0 / al) * torch.pow(1.0 + tau / al, -(al + 2.0))

    def pulse(tau, p):
        a, b, n = p[..., 0:1], p[..., 1:2], p[..., 2:3]
        idxf = _pulse_cell(tau, a, b, n)
        idx = torch.floor(idxf)
        return (1.0 / n) * torch.where(torch.abs(idxf - idx - 0.5) < 1e-3,
                                       1.0, 0.0)

    # davis_weinstein: the reference's second-derivative form is lengthy;
    # the JAX package uses surfaceMedium (its media start on surfaces)
    return _dispatch(ttype, tau, p, {
        T_EXPONENTIAL: exp_, T_DOUBLE_EXPONENTIAL: dexp, T_LINEAR: lin,
        T_QUADRATIC: quad, T_ERLANG: erl, T_DAVIS: davis,
        T_DAVIS_WEINSTEIN: _dw_surface_medium, T_PULSE: pulse}, laws)


def _sigma_bar_base(ttype, p, laws):
    out = torch.ones(ttype.shape, dtype=torch.float32, device=ttype.device)
    for law, val in (
            (T_DOUBLE_EXPONENTIAL, lambda: 0.5 * (p[..., 0] + p[..., 1])),
            (T_LINEAR, lambda: 1.0 / torch.clamp(p[..., 0], min=1e-20)),
            (T_QUADRATIC, lambda: 2.0 / torch.clamp(p[..., 0], min=1e-20)),
            (T_ERLANG, lambda: p[..., 0] * 0.5),
            (T_PULSE, lambda: 2.0 / torch.clamp(p[..., 1] - p[..., 0],
                                                min=1e-20))):
        if _has(laws, law):
            out = torch.where(ttype == law, val(), out)
    return out


# ---- public four-kernel wrappers: interpolated = lerp of two child laws
# (ref InterpolatedTransmittance.cpp:44-70).  Active only when the param
# table carries the 16-column interpolated layout.

def _interp(p, laws) -> bool:
    return p.shape[-1] >= 16 and _has(laws, T_INTERPOLATED)


def _is_dirac(ttype):
    out = torch.zeros(ttype.shape, dtype=torch.bool, device=ttype.device)
    for t in _DIRAC_LAWS:
        out = out | (ttype == t)
    return out


def sigma_bar(ttype, p, laws=None):
    out = _sigma_bar_base(ttype, p, laws)
    if not _interp(p, laws):
        return out
    u = p[..., 6]
    sa = _sigma_bar_base(p[..., 4].to(torch.int32), p[..., 8:12], laws)
    sb = _sigma_bar_base(p[..., 5].to(torch.int32), p[..., 12:16], laws)
    # sigmaBar = 1 / lerp(1/A.sigmaBar, 1/B.sigmaBar, u)
    mix = 1.0 / ((1.0 - u) / sa + u / sb)
    return torch.where(ttype == T_INTERPOLATED, mix, out)


def surface_surface(ttype, tau, p, laws=None):
    out = _surface_surface_base(ttype, tau, p, laws)
    if not _interp(p, laws):
        return out
    ta, tb, u, pa, pb = _interp_parts(p)
    sa = _sigma_bar_base(ta, pa, laws)[..., None]
    sb = _sigma_bar_base(tb, pb, laws)[..., None]
    sbar = sigma_bar(ttype, p, laws)[..., None]
    mix = sbar * ((1.0 - u) * _surface_surface_base(ta, tau, pa, laws) / sa
                  + u * _surface_surface_base(tb, tau, pb, laws) / sb)
    return torch.where(ttype[..., None] == T_INTERPOLATED, mix, out)


def medium_surface(ttype, tau, p, laws=None):
    out = _medium_surface_base(ttype, tau, p, laws)
    if not _interp(p, laws):
        return out
    ta, tb, u, pa, pb = _interp_parts(p)
    mix = ((1.0 - u) * _medium_surface_base(ta, tau, pa, laws)
           + u * _medium_surface_base(tb, tau, pb, laws))
    return torch.where(ttype[..., None] == T_INTERPOLATED, mix, out)


def surface_medium(ttype, tau, p, laws=None):
    out = _surface_medium_base(ttype, tau, p, laws)
    if not _interp(p, laws):
        return out
    # interpolated surfaceMedium = mediumSurface * sigmaBar
    mix = medium_surface(ttype, tau, p, laws) * \
        sigma_bar(ttype, p, laws)[..., None]
    return torch.where(ttype[..., None] == T_INTERPOLATED, mix, out)


def medium_medium(ttype, tau, p, laws=None):
    out = _medium_medium_base(ttype, tau, p, laws)
    if not _interp(p, laws):
        return out
    ta, tb, u, pa, pb = _interp_parts(p)
    mma = _medium_medium_base(ta, tau, pa, laws)
    mmb = _medium_medium_base(tb, tau, pb, laws)
    # dirac exception: if exactly one child is dirac with mass here, its
    # density dominates the lerp (InterpolatedTransmittance.cpp:58-68)
    da = _is_dirac(ta)[..., None] & (mma > 0.0)
    db = _is_dirac(tb)[..., None] & (mmb > 0.0)
    lerped = (1.0 - u) * mma + u * mmb
    mix = torch.where(da ^ db, torch.where(da, mma, mmb), lerped)
    return torch.where(ttype[..., None] == T_INTERPOLATED, mix, out)


def eval_tr(ttype, tau, p, start_on_surface, end_on_surface, laws=None):
    """Transmittance eval with surface/medium endpoint classification.
    NOTE: both mixed cases return mediumSurface, exactly as the
    reference (Transmittance.hpp:22-30), where the final else covers
    surface->medium AND medium->surface with mediumSurface(tau)."""
    ss = surface_surface(ttype, tau, p, laws)
    mm = medium_medium(ttype, tau, p, laws) / \
        sigma_bar(ttype, p, laws)[..., None]
    both_s = start_on_surface[..., None] & end_on_surface[..., None]
    neither = ~start_on_surface[..., None] & ~end_on_surface[..., None]
    return torch.where(both_s, ss,
                       torch.where(neither, mm,
                                   medium_surface(ttype, tau, p, laws)))


def surface_probability(ttype, tau, p, start_on_surface, laws=None):
    return torch.where(start_on_surface[..., None],
                       surface_surface(ttype, tau, p, laws),
                       medium_surface(ttype, tau, p, laws))


def medium_pdf(ttype, tau, p, start_on_surface, laws=None):
    return torch.where(start_on_surface[..., None],
                       surface_medium(ttype, tau, p, laws),
                       medium_medium(ttype, tau, p, laws))


def _sample_distance_base(ttype, p, start_on_surface, u1, u2, laws):
    """Sample unit-optical-depth free flight (ref sampleSurface /
    sampleMedium per law; u2 feeds two-branch laws)."""
    u1 = torch.clamp(u1, max=1.0 - 1e-7)
    exp_t = -torch.log(1.0 - u1)
    out = exp_t

    def pick(law, surf, med):
        return torch.where(ttype == law,
                           torch.where(start_on_surface, surf, med), out)

    if _has(laws, T_DOUBLE_EXPONENTIAL):
        sa, sb = p[..., 0], p[..., 1]
        on_a = exp_t / torch.clamp(sa, min=1e-20)
        on_b = exp_t / torch.clamp(sb, min=1e-20)
        out = pick(T_DOUBLE_EXPONENTIAL, torch.where(u2 < 0.5, on_a, on_b),
                   torch.where(u2 < sa / torch.clamp(sa + sb, min=1e-20),
                               on_a, on_b))
    mt = p[..., 0]
    if _has(laws, T_LINEAR):
        out = pick(T_LINEAR, mt * u1, mt)
    if _has(laws, T_QUADRATIC):
        out = pick(T_QUADRATIC,
                   mt * (1.0 - torch.sqrt(torch.clamp(1.0 - u1, min=0.0))),
                   mt * u1)
    if _has(laws, T_ERLANG):
        lam = torch.clamp(p[..., 0], min=1e-20)
        # erlang surface sampling: 10 Newton iterations on 1 - S(x) = u
        x = torch.full_like(u1, 0.5)
        for _ in range(10):
            s = 0.5 * torch.exp(-lam * x) * (2.0 + lam * x)
            dens = torch.exp(-lam * x) * (1.0 + lam * x) * lam * 0.5
            x = torch.clamp(x + (u1 - (1.0 - s)) /
                            torch.clamp(dens, min=1e-20), min=0.0)
        out = pick(T_ERLANG, x,
                   -1.0 / lam * torch.log(torch.clamp(u1 * u2, min=1e-20)))
    if _has(laws, T_DAVIS) or _has(laws, T_DAVIS_WEINSTEIN):
        al = torch.clamp(p[..., 0], min=1e-20)
        davis_surf = al * (torch.pow(1.0 - u1, -1.0 / al) - 1.0)
        davis_med = al * (torch.pow(1.0 - u1, -1.0 / (1.0 + al)) - 1.0)
        for law in (T_DAVIS, T_DAVIS_WEINSTEIN):
            if _has(laws, law):
                out = pick(law, davis_surf, davis_med)
    if _has(laws, T_PULSE):
        # pulse surfaces: unrolled inverse-CDF over MAX_PULSES trapezoid
        # cells
        a_, b_ = p[..., 0], p[..., 1]
        n_ = clip(p[..., 2], 1.0)
        xi = u1 * n_ * 0.5
        delta = 1.0 / n_
        pulse_surf = torch.zeros_like(u1)
        found = torch.zeros_like(u1, dtype=torch.bool)
        for i in range(MAX_PULSES):
            valid = i < n_
            h0 = (1.0 - i * delta)
            h1 = (1.0 - (i + 1.0) * delta)
            hit0 = (~found) & valid & (xi - h0 * 0.5 < 0.0)
            pulse_surf = torch.where(
                hit0, a_ + (i + 0.5 * u2) * (b_ - a_) * delta, pulse_surf)
            found = found | hit0
            xi = torch.where(valid & ~found, xi - h0 * 0.5, xi)
            hit1 = (~found) & valid & (xi - h1 * 0.5 < 0.0)
            pulse_surf = torch.where(
                hit1, a_ + (i + 0.5 + 0.5 * u2) * (b_ - a_) * delta,
                pulse_surf)
            found = found | hit1
            xi = torch.where(valid & ~found, xi - h1 * 0.5, xi)
        out = pick(T_PULSE, pulse_surf,
                   a_ + (0.5 + torch.floor(u1 * n_)) / n_ * (b_ - a_))
    return out


def sample_distance(ttype, p, start_on_surface, u1, u2, laws=None):
    out = _sample_distance_base(ttype, p, start_on_surface, u1, u2, laws)
    if not _interp(p, laws):
        return out
    # interpolated: child B with probability ratio, else A (ref
    # InterpolatedTransmittance::sampleSurface/sampleMedium); u2 is
    # rescaled after the discrete choice so two-branch children keep an
    # independent uniform
    ta = p[..., 4].to(torch.int32)
    tb = p[..., 5].to(torch.int32)
    r = p[..., 6]
    pick_b = u2 < r
    u2r = torch.where(pick_b, u2 / torch.clamp(r, min=1e-7),
                      (u2 - r) / torch.clamp(1.0 - r, min=1e-7))
    da = _sample_distance_base(ta, p[..., 8:12], start_on_surface, u1, u2r,
                               laws)
    db = _sample_distance_base(tb, p[..., 12:16], start_on_surface, u1, u2r,
                               laws)
    return torch.where(ttype == T_INTERPOLATED,
                       torch.where(pick_b, db, da), out)
