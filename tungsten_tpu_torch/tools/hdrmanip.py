"""hdrmanip: HDR image toolkit — convert/tonemap/exposure, merge-average
multiple renders (the reference's manual multi-machine reduction), and
image metrics (mse/rmse/maps/variance) used for verification.

CLI parity with ref src/hdrmanip/hdrmanip.cpp (flags -o/-m/-w/-e/-a/-t/-f,
--mse/--rmse/--mse-map/--rmse-map/--variance).

The port's own copy of tungsten_tpu/tools/hdrmanip.py, on the port's io/
and scene/.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np


def load(path):
    from tungsten_tpu_torch.io.image import load_image
    return load_image(path).astype(np.float64)


def save(path, img, tonemap_op="gamma"):
    from tungsten_tpu_torch.io import image as im
    if im.is_hdr(path):
        im.save_hdr(path, img.astype(np.float32))
    else:
        from tungsten_tpu_torch.cameras.camera import tonemap_image
        im.save_ldr(path, tonemap_image(tonemap_op, img))


def mse(a, b):
    return float(np.mean((a - b) ** 2))


def rmse(a, b):
    """Relative MSE (ref hdrmanip): (a-b)^2 / (b^2 + eps)."""
    return float(np.mean((a - b) ** 2 / (b * b + 1e-3)))


def error_map(a, b, relative=False):
    e = np.mean((a - b) ** 2, axis=-1)
    if relative:
        e = e / (np.mean(b * b, axis=-1) + 1e-3)
    # simple heat map: normalize by 95th percentile
    scale = np.percentile(e, 95) or 1.0
    t = np.clip(e / scale, 0, 1)
    heat = np.stack([t, 4 * t * (1 - t), 1 - t], axis=-1)
    return heat


def merge(images, weights=None):
    ws = weights or [1.0] * len(images)
    acc = np.zeros_like(images[0])
    for img, w in zip(images, ws):
        acc += img * w
    return acc / sum(ws)


def variance(images):
    stack = np.stack(images)
    return float(stack.var(axis=0, ddof=1).mean())


def main(argv=None):
    p = argparse.ArgumentParser(prog="hdrmanip")
    p.add_argument("files", nargs="+")
    p.add_argument("-o", "--output", default=None)
    p.add_argument("-m", "--merge", action="store_true")
    p.add_argument("-w", "--weights", default=None)
    p.add_argument("-e", "--exposure", type=float, default=0.0)
    p.add_argument("-a", "--average", action="store_true")
    p.add_argument("-t", "--tonemap", default="gamma")
    p.add_argument("-f", "--filetype", default="png")
    p.add_argument("--mse", action="store_true")
    p.add_argument("--rmse", action="store_true")
    p.add_argument("--mse-map", action="store_true")
    p.add_argument("--rmse-map", action="store_true")
    p.add_argument("--variance", action="store_true")
    args = p.parse_args(argv)

    imgs = [load(f) for f in args.files]
    if args.exposure:
        imgs = [i * (2.0 ** args.exposure) for i in imgs]

    if args.average:
        for f, i in zip(args.files, imgs):
            print(f"{f}: {i.mean(axis=(0, 1))}")
        return
    if args.mse or args.rmse:
        fn = mse if args.mse else rmse
        print(fn(imgs[0], imgs[1]))
        return
    if args.mse_map or args.rmse_map:
        m = error_map(imgs[0], imgs[1], relative=args.rmse_map)
        save(args.output or "error_map.png", m, args.tonemap)
        return
    if args.variance:
        print(variance(imgs))
        return
    if args.merge:
        ws = ([float(x) for x in args.weights.split(",")]
              if args.weights else None)
        out = merge(imgs, ws)
        save(args.output or "merged.pfm", out, args.tonemap)
        return
    # plain convert
    for f, img in zip(args.files, imgs):
        if args.output and len(imgs) == 1:
            dst = args.output
        else:
            dst = os.path.splitext(f)[0] + "." + args.filetype
        save(dst, img, args.tonemap)


if __name__ == "__main__":
    main()
