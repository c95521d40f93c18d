"""Device-side debug checks (port of tungsten_tpu/utils/debug.py; the
reference's DEBUG-build asserts + enableConsistencyChecks,
src/core/Debug.hpp).

The JAX package threads `checkify` error state through its compiled
trace, whose float checks flag a NaN or inf produced by any op.
PyTorch runs eagerly, so here the checks are reductions on the device,
read back once after the trace: (a) the float checks, every float table
of the scene finite (the trace's estimator guards mask a NaN that a
table feeds it, so the output alone would not show it) and every
radiance finite, and (b) the transport invariant the reference guards,
non-negative radiance (ref PathTracer.cpp:119-122's NaN scrub +
consistency checks).  Opt-in, not on the hot path.
"""
from __future__ import annotations

import torch


def checked_trace(scene, settings, pixel, sample_idx, seed,
                  float_checks: bool = True):
    """Run trace_wave with the checks; returns (err, radiance).

    err is None when every sample satisfied the checks; otherwise it is
    the first failed check's message (device-side detection, host-side
    report, as checkify's err.get())."""
    from dataclasses import fields
    from tungsten_tpu_torch.integrators.path_tracer import trace_wave
    rad = trace_wave(scene, settings, pixel, sample_idx, seed)
    checks = []
    if float_checks:
        for f in fields(scene):
            v = getattr(scene, f.name)
            if isinstance(v, torch.Tensor) and v.is_floating_point():
                checks.append((torch.isfinite(v).all(),
                               f"non-finite value in scene table {f.name}"))
        checks.append((torch.isfinite(rad).all(),
                       "non-finite radiance in wavefront output"))
    checks.append((torch.all(rad > -1e-5),
                   "negative radiance in wavefront output"))
    passed = torch.stack([c for c, _ in checks]).cpu().tolist()
    for ok, (_, msg) in zip(passed, checks):
        if not ok:
            return msg, rad
    return None, rad
