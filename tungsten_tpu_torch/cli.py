"""`tungsten`-equivalent CLI renderer (port of tungsten_tpu/cli.py).

Mirrors the reference CLI (ref: src/tungsten/tungsten.cpp:6-23,
src/tungsten/Shared.hpp:134-145): scene queue, spp/seed/output overrides,
spp-step rounds with checkpointing, timeout, resume and restart,
adaptive sampling above 16 spp, and the scene's `output_buffers`
(color with variance and A/B halves, depth, normal, albedo, visibility).

Usage:  python -m tungsten_tpu_torch.cli [options] scene1.json [...]

The render runs on the CUDA device; `--device cpu` runs the plain
PyTorch path on the CPU instead.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from dataclasses import replace


def parse_duration(s: str) -> float:
    """'1h30m', '15m', '90s', '0' -> seconds (ref StringUtils::parseDuration)."""
    s = str(s).strip()
    if not s or s == "0":
        return 0.0
    total = 0.0
    num = ""
    for ch in s:
        if ch.isdigit() or ch == ".":
            num += ch
        elif ch in "hms" and num:
            total += float(num) * {"h": 3600, "m": 60, "s": 1}[ch]
            num = ""
    if num:
        total += float(num)
    return total


def render_scene(path, args) -> dict:
    """Render one scene file as the reference CLI does.  Returns
    {"rays", "seconds", "spp" (samples done), "files" (every file
    written, in order)}."""
    import numpy as np
    from tungsten_tpu_torch.device import resolve_device
    from tungsten_tpu_torch.integrators.checkpoint import (
        load_resume_state, save_resume_state, scene_hash)
    from tungsten_tpu_torch.render import (ADAPTIVE_THRESHOLD,
                                           _finalize_buffers, render_pass,
                                           render_with_aovs)
    from tungsten_tpu_torch.scene.flatten import load_flat_scene

    device = resolve_device(args.device)
    print(f"Loading scene {path}")
    scene, settings = load_flat_scene(path, device)
    if settings.integrator_type != "path_tracer":
        raise NotImplementedError(
            f"tungsten_tpu_torch: integrator {settings.integrator_type!r} is "
            f"not ported yet")
    if args.spp:
        settings = replace(settings, spp=args.spp)
    if args.seed is not None:
        settings = replace(settings, seed=args.seed)

    with open(path) as f:
        sjson = json.load(f)
    rjson = sjson.get("renderer", {})
    out_dir = args.output_directory or os.path.dirname(path)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    output_file = args.output_file or rjson.get("output_file",
                                                "TungstenRender.png")
    hdr_output = args.hdr_output_file or rjson.get("hdr_output_file")
    resume_file = os.path.join(
        out_dir, rjson.get("resume_render_file", "TungstenRenderState.dat"))
    enable_resume = bool(rjson.get("enable_resume_render", False))
    checkpoint_s = parse_duration(args.checkpoint or
                                  rjson.get("checkpoint_interval", "0"))
    timeout_s = parse_duration(args.timeout or rjson.get("timeout", "0"))

    shash = scene_hash(sjson)
    buf_specs = [b for b in rjson.get("output_buffers", [])
                 if b.get("type") in ("color", "depth", "normal",
                                      "albedo", "visibility")]
    # output buffers requested: trace through the AOV-tracking wavefront
    # so color and AOVs come from the SAME samples, with Welford
    # variance + parity half-buffers — reference semantics
    # (PathTracer::_trackOutputValues, OutputBuffer::addSample)
    use_buffers = bool(buf_specs)
    files: list[str] = []
    total_rays = 0

    acc = np.zeros((settings.height, settings.width, 3))
    raw_acc = None
    start_spp = 0
    if enable_resume and not args.restart and os.path.exists(resume_file):
        st = load_resume_state(resume_file, shash)
        if st is not None:
            acc, start_spp = st["framebuffer"], st["current_spp"]
            if st["buffers"]:
                raw_acc = st["buffers"]
            print(f"Resuming render from {resume_file} at {start_spp} spp")

    spp = settings.spp
    step = max(1, settings.spp_step)
    t_start = time.time()
    t_checkpoint = time.time()
    done = start_spp
    bufs = None

    use_adaptive = (settings.adaptive_sampling and not use_buffers
                    and spp > ADAPTIVE_THRESHOLD)
    if use_adaptive:
        # adaptive renders checkpoint their full tile statistics +
        # sample cursors (ref PathTraceIntegrator.cpp:158-172) so a
        # resumed run continues the budget allocation, not just the
        # framebuffer
        from tungsten_tpu_torch.render import (adaptive_state_buffers,
                                               adaptive_state_from_buffers,
                                               render_adaptive)
        ad_state = adaptive_state_from_buffers(raw_acc) if raw_acc else None

        def _round_cb(st):
            nonlocal t_checkpoint
            now = time.time()
            if enable_resume and checkpoint_s and \
                    now - t_checkpoint > checkpoint_s:
                img_c = st["fb"] / np.maximum(
                    st["px_count"][:, None], 1.0)
                save_resume_state(
                    resume_file, shash,
                    img_c.reshape(settings.height, settings.width, 3),
                    st["done"], buffers=adaptive_state_buffers(st))
                t_checkpoint = now

        img, rays, secs, ad_state = render_adaptive(
            scene, settings, spp, settings.seed, verbose=True,
            state=ad_state, round_cb=_round_cb)
        print(f"Adaptive render {ad_state['done']} spp rounds "
              f"({secs:.2f}s, {rays / max(secs, 1e-9) / 1e6:.1f} Mrays/s)")
        if enable_resume:
            save_resume_state(resume_file, shash, img, ad_state["done"],
                              buffers=adaptive_state_buffers(ad_state))
            files.append(resume_file)
        files += _write_outputs(img, settings, out_dir, output_file,
                                hdr_output)
        wall = time.time() - t_start
        print(f"Finished render. Render time {wall:.1f}s")
        return dict(rays=int(rays), seconds=wall, spp=ad_state["done"],
                    files=files)

    while done < spp:
        chunk = min(step, spp - done)
        t0 = time.time()
        if use_buffers:
            stats = {}
            bufs, raw_acc = render_with_aovs(
                scene, settings, spp=done + chunk,
                seed=settings.seed, acc=raw_acc, sample_start=done,
                stats=stats)
            acc = bufs["color"] * (done + chunk)
            rays = stats["rays"]
        else:
            out, rays = render_pass(scene, settings, done, settings.seed,
                                    spp_chunk=chunk)
            acc += out.cpu().numpy()
        total_rays += int(rays)
        done += chunk
        dt = time.time() - t0
        print(f"Completed {done}/{spp} spp "
              f"({dt:.2f}s, {int(rays)/dt/1e6:.1f} Mrays/s)")
        if checkpoint_s and time.time() - t_checkpoint > checkpoint_s:
            save_resume_state(resume_file, shash, acc, done,
                              buffers=raw_acc)
            _write_outputs(acc / done, settings, out_dir,
                           output_file, hdr_output, suffix="_checkpoint")
            t_checkpoint = time.time()
        if timeout_s and time.time() - t_start > timeout_s:
            print("Timeout reached")
            break

    if enable_resume:
        save_resume_state(resume_file, shash, acc, done, buffers=raw_acc)
        files.append(resume_file)
    files += _write_outputs(acc / max(done, 1), settings, out_dir,
                            output_file, hdr_output)
    if buf_specs and bufs is None:
        # no round ran (resumed at the target spp): the buffers of the
        # resumed accumulators, or, where the state file holds none, a
        # small separate pass as the JAX package renders
        if raw_acc is not None and "color_sum" in raw_acc:
            bufs = _finalize_buffers(raw_acc, done, settings.width,
                                     settings.height)
        else:
            bufs, _ = render_with_aovs(scene, settings, spp=min(spp, 8),
                                       seed=settings.seed)
    if buf_specs:
        files += _write_output_buffers(bufs, buf_specs, out_dir)
    wall = time.time() - t_start
    print(f"Finished render. Render time {wall:.1f}s")
    return dict(rays=total_rays, seconds=wall, spp=done, files=files)


def _write_output_buffers(bufs, buf_specs, out_dir) -> list[str]:
    """Per-buffer files (ref OutputBuffer::save): mean image, optional
    `Variance` (sample_variance), optional `A`/`B` half buffers for the
    color buffer (two_buffer_variance; AOV A/B splits are not tracked).
    Returns the paths written."""
    import numpy as np
    from tungsten_tpu_torch.io import image as im2
    written = []

    def write(name, img):
        if img.ndim == 2:
            img = np.repeat(img[..., None], 3, axis=-1)
        target = os.path.join(out_dir, name)
        if im2.is_hdr(target):
            im2.save_hdr(target, img.astype(np.float32))
        else:
            im2.save_ldr(target, np.clip(img, 0, 1))
        print(f"Wrote output buffer -> {target}")
        written.append(target)

    def with_tag(fn, tag):
        base, ext = os.path.splitext(fn)
        return base + tag + ext

    for spec in buf_specs:
        typ = spec["type"]
        fn = spec.get("hdr_output_file") or spec.get("output_file") \
            or f"{typ}.pfm"
        write(fn, np.asarray(bufs[typ]))
        if spec.get("sample_variance"):
            write(with_tag(fn, "Variance"),
                  np.asarray(bufs[typ + "_variance"]))
        if spec.get("two_buffer_variance") and typ == "color":
            write(with_tag(fn, "A"), np.asarray(bufs["color_a"]))
            write(with_tag(fn, "B"), np.asarray(bufs["color_b"]))
    return written


def _write_outputs(hdr, settings, out_dir, output_file, hdr_output,
                   suffix="") -> list[str]:
    """The tonemapped LDR image and the optional HDR image; returns the
    paths written."""
    from tungsten_tpu_torch.cameras.camera import tonemap_image
    from tungsten_tpu_torch.io import image as im

    def with_suffix(name):
        base, ext = os.path.splitext(name)
        return os.path.join(out_dir, base + suffix + ext)

    written = [with_suffix(output_file)]
    im.save_ldr(written[0], tonemap_image(settings.tonemap, hdr))
    if hdr_output:
        written.append(with_suffix(hdr_output))
        im.save_hdr(written[1], hdr)
    return written


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tungsten_tpu_torch")
    p.add_argument("scenes", nargs="+")
    p.add_argument("-r", "--restart", action="store_true",
                   help="ignore resume state, start from 0 spp")
    p.add_argument("-c", "--checkpoint", default=None,
                   help="checkpoint interval (duration string)")
    p.add_argument("-d", "--output-directory", default=None)
    p.add_argument("--spp", type=int, default=None)
    p.add_argument("--timeout", default=None)
    p.add_argument("-s", "--seed", type=int, default=None)
    p.add_argument("-o", "--output-file", default=None)
    p.add_argument("-e", "--hdr-output-file", default=None)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu (the plain PyTorch path)")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    for scene_path in args.scenes:
        try:
            render_scene(scene_path, args)
        except Exception as e:  # keep the queue going, like the reference
            print(f"Render of {scene_path} failed: {e}", file=sys.stderr)


if __name__ == "__main__":
    main()
