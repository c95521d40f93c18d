"""Host-side image IO (port of tungsten_tpu/io/image.py): Radiance HDR
(RGBE), PFM and uncompressed/zip EXR in numpy, LDR loads through PIL,
and 8-bit PNG written and read with zlib alone (other LDR writes need
PIL).

Parity notes (ref: src/core/io/ImageIO.cpp:159-163,367-375,493,610-622):
extension dispatch; HDR formats hold linear radiance; LDR loads are
gamma-2.2 expanded to linear unless the caller asks for raw values.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np


# ----------------------------------------------------------------- RGBE .hdr

def _load_rgbe(path) -> np.ndarray:
    """Pure-numpy Radiance .hdr (RGBE) reader supporting the common
    RLE-encoded 32-bit_rle_rgbe files."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: text lines until blank, then resolution line.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance HDR file")
    while True:
        eol = data.index(b"\n", pos)
        line = data[pos:eol]
        pos = eol + 1
        if line == b"":
            break
    eol = data.index(b"\n", pos)
    res_line = data[pos:eol].decode("ascii").split()
    pos = eol + 1
    if res_line[0] != "-Y" or res_line[2] != "+X":
        raise ValueError(f"{path}: unsupported orientation {res_line}")
    h, w = int(res_line[1]), int(res_line[3])

    raw = np.frombuffer(data, dtype=np.uint8, offset=pos)
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    off = 0
    for y in range(h):
        if off + 4 <= len(raw) and raw[off] == 2 and raw[off + 1] == 2 and \
                (int(raw[off + 2]) << 8 | int(raw[off + 3])) == w:
            # New-style RLE scanline: 4 components stored separately.
            off += 4
            for c in range(4):
                x = 0
                while x < w:
                    count = int(raw[off]); off += 1
                    if count > 128:
                        count -= 128
                        rgbe[y, x:x + count, c] = raw[off]
                        off += 1
                    else:
                        rgbe[y, x:x + count, c] = raw[off:off + count]
                        off += count
                    x += count
        else:
            # Flat scanline.
            n = w * 4
            rgbe[y] = raw[off:off + n].reshape(w, 4)
            off += n
    exp = rgbe[..., 3].astype(np.int32)
    scale = np.where(exp == 0, 0.0, np.ldexp(1.0, exp - 136)).astype(np.float32)
    return (rgbe[..., :3].astype(np.float32) + 0.5) * scale[..., None] * np.where(
        exp[..., None] == 0, 0.0, 1.0
    ).astype(np.float32)


def _save_rgbe(path, img: np.ndarray) -> None:
    img = np.asarray(img, dtype=np.float32)
    h, w = img.shape[:2]
    m = np.max(img, axis=-1)
    exp = np.zeros((h, w), dtype=np.int32)
    nz = m >= 1e-32
    _, e = np.frexp(np.where(nz, m, 1.0))
    scale = np.ldexp(1.0, -e) * 256.0 / 1.0
    rgbe = np.zeros((h, w, 4), dtype=np.uint8)
    vals = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., :3] = np.where(nz[..., None], vals, 0)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    del exp
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode("ascii"))
        f.write(rgbe.tobytes())


# ---------------------------------------------------------------------- PFM

def _load_pfm(path) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        channels = 3 if header == b"PF" else 1
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), dtype="<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, channels)[::-1]  # PFM rows are bottom-up
    return np.ascontiguousarray(img, dtype=np.float32)


def _save_pfm(path, img: np.ndarray) -> None:
    img = np.asarray(img, dtype="<f4")
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"PF\n" if img.ndim == 3 else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")
        f.write(np.ascontiguousarray(img[::-1]).tobytes())


# ---------------------------------------------------------------------- EXR
#
# The OpenCV build in this environment has no EXR codec, so a minimal
# pure-python OpenEXR 2.0 single-part scanline codec lives here:
# writer emits ZIPS-compressed float32 RGB; reader handles NONE / ZIPS /
# ZIP compression with the standard delta-predictor + byte de-interleave.
# (Replaces the reference's OpenEXR dependency, ImageIO.cpp:367-375.)

_EXR_MAGIC = 0x01312F76
_PT_FLOAT = 2


def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    import struct
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def _save_exr(path, img: np.ndarray) -> None:
    import struct
    import zlib
    img = np.atleast_3d(np.asarray(img, dtype="<f4"))
    h, w, c = img.shape
    names = [b"B", b"G", b"R"][:c] if c == 3 else \
        [b"Y"] if c == 1 else [bytes([65 + i]) for i in range(c)]
    order = [2, 1, 0] if c == 3 else list(range(c))  # channel per name

    chlist = b""
    for n in names:
        chlist += n + b"\0" + struct.pack("<i", _PT_FLOAT) + \
            b"\x00\x00\x00\x00" + struct.pack("<ii", 1, 1)
    chlist += b"\0"

    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b""
    header += _exr_attr(b"channels", b"chlist", chlist)
    header += _exr_attr(b"compression", b"compression", b"\x02")  # ZIPS
    header += _exr_attr(b"dataWindow", b"box2i", box)
    header += _exr_attr(b"displayWindow", b"box2i", box)
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\x00")
    header += _exr_attr(b"pixelAspectRatio", b"float",
                        struct.pack("<f", 1.0))
    header += _exr_attr(b"screenWindowCenter", b"v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr(b"screenWindowWidth", b"float",
                        struct.pack("<f", 1.0))
    header += b"\0"

    chunks = []
    for y in range(h):
        raw = b"".join(np.ascontiguousarray(img[y, :, k]).tobytes()
                       for k in order)
        pred = _exr_predict_encode(raw)
        comp = zlib.compress(pred)
        if len(comp) >= len(raw):
            comp = raw
        chunks.append(struct.pack("<ii", y, len(comp)) + comp)

    with open(path, "wb") as f:
        f.write(struct.pack("<iI", _EXR_MAGIC, 2))
        f.write(header)
        off = f.tell() + 8 * h
        for ch in chunks:
            f.write(struct.pack("<Q", off))
            off += len(ch)
        for ch in chunks:
            f.write(ch)


def _exr_predict_encode(data: bytes) -> bytes:
    # EXR zip pre-filter: split bytes into two interleaved halves, then
    # delta-encode (the inverse of the reader's reconstruct+interleave)
    a = np.frombuffer(data, np.uint8)
    half = (len(a) + 1) // 2
    split = np.empty_like(a)
    split[:half] = a[0::2]
    split[half:] = a[1::2]
    d = split.astype(np.int16)
    out = np.empty_like(split)
    out[0] = split[0]
    out[1:] = ((d[1:] - d[:-1] + 128 + 256) % 256).astype(np.uint8)
    return out.tobytes()


def _exr_predict_decode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8).astype(np.int64)
    a[1:] = a[1:] - 128
    rec = np.cumsum(a) % 256
    rec = rec.astype(np.uint8)
    half = (len(rec) + 1) // 2
    out = np.empty_like(rec)
    out[0::2] = rec[:half]
    out[1::2] = rec[half:]
    return out.tobytes()


def _load_exr(path) -> np.ndarray:
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    magic, ver = struct.unpack_from("<iI", data, 0)
    if magic != _EXR_MAGIC:
        raise IOError(f"{path}: not an EXR file")
    if ver & 0x200:
        raise IOError(f"{path}: multi-part EXR not supported")
    pos = 8

    channels = []  # (name, pixel_type)
    compression = 0
    dw = (0, 0, 0, 0)
    while True:
        if data[pos] == 0:
            pos += 1
            break
        e = data.index(b"\0", pos)
        name = data[pos:e]; pos = e + 1
        e = data.index(b"\0", pos)
        typ = data[pos:e]; pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos); pos += 4
        val = data[pos:pos + size]; pos += size
        if name == b"channels":
            p = 0
            while val[p] != 0:
                ce = val.index(b"\0", p)
                cname = val[p:ce]; p = ce + 1
                (ptype,) = struct.unpack_from("<i", val, p)
                p += 16
                channels.append((cname.decode(), ptype))
        elif name == b"compression":
            compression = val[0]
        elif name == b"dataWindow":
            dw = struct.unpack("<iiii", val)
    x0, y0, x1, y1 = dw
    w, h = x1 - x0 + 1, y1 - y0 + 1
    if compression not in (0, 2, 3):
        raise IOError(f"{path}: unsupported EXR compression {compression}")
    lines_per_chunk = 16 if compression == 3 else 1
    n_chunks = (h + lines_per_chunk - 1) // lines_per_chunk
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)

    dtypes = {0: np.uint32, 1: np.float16, 2: np.float32}
    out = {c: np.zeros((h, w), np.float32) for c, _ in channels}
    for off in offsets:
        y, size = struct.unpack_from("<ii", data, off)
        raw = data[off + 8:off + 8 + size]
        ny = min(lines_per_chunk, y1 - y + 1)
        expect = sum(w * ny * np.dtype(dtypes[t]).itemsize
                     for _, t in channels)
        if compression and size != expect:
            raw = _exr_predict_decode(zlib.decompress(raw))
        p = 0
        for line in range(ny):
            for cname, ptype in channels:
                dt = np.dtype(dtypes[ptype]).newbyteorder("<")
                nb = w * dt.itemsize
                row = np.frombuffer(raw, dt, count=w, offset=p)
                out[cname][y - y0 + line] = row.astype(np.float32)
                p += nb
    if all(k in out for k in ("R", "G", "B")):
        img = np.stack([out["R"], out["G"], out["B"]], axis=-1)
    elif "Y" in out:
        img = out["Y"]
    else:
        img = np.stack([out[c] for c, _ in channels], axis=-1)
    return np.ascontiguousarray(img, dtype=np.float32)


# ------------------------------------------------------------------- public

HDR_EXTS = (".hdr", ".pic", ".pfm", ".exr")


def is_hdr(path) -> bool:
    return str(path).lower().endswith(HDR_EXTS)


def load_hdr(path) -> np.ndarray:
    p = str(path).lower()
    if p.endswith((".hdr", ".pic")):
        return _load_rgbe(path)
    if p.endswith(".pfm"):
        return _load_pfm(path)
    if p.endswith(".exr"):
        return _load_exr(path)
    raise ValueError(f"unsupported HDR format: {path}")


def save_hdr(path, img: np.ndarray) -> None:
    p = str(path).lower()
    if p.endswith((".hdr", ".pic")):
        _save_rgbe(path, img)
    elif p.endswith(".pfm"):
        _save_pfm(path, img)
    elif p.endswith(".exr"):
        _save_exr(path, img)
    else:
        raise ValueError(f"unsupported HDR format: {path}")


def load_ldr(path, gamma: bool = True) -> np.ndarray:
    """Load an 8-bit image as float32.  gamma=True expands sRGB-ish 2.2 gamma
    to linear, matching the reference's texture load behavior."""
    from PIL import Image
    img = np.asarray(Image.open(path).convert("RGB"), dtype=np.float32) / 255.0
    if gamma:
        img = img ** 2.2
    return img


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data +
            struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """An (H, W, 3) [0, 1] float image as 8-bit RGB PNG bytes (zlib and
    struct only: the machines the port runs on may lack PIL)."""
    arr = np.clip(np.asarray(img, np.float64) * 255.0 + 0.5, 0, 255) \
        .astype(np.uint8)
    if arr.ndim == 2:
        arr = np.repeat(arr[..., None], 3, axis=-1)
    h, w = arr.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           arr[..., :3].reshape(h, w * 3)], axis=1)
    return (b"\x89PNG\r\n\x1a\n" +
            _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + _png_chunk(b"IEND", b""))


def decode_png(data: bytes) -> np.ndarray:
    """8-bit RGB or RGBA, non-interlaced PNG bytes -> (H, W, 3) uint8 (the
    PNGs encode_png writes, and those of other 8-bit writers)."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG file")
    pos, idat, w = 8, [], 0
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB",
                                                                body)
            if depth != 8 or ctype not in (2, 6) or interlace:
                raise ValueError("only 8-bit RGB/RGBA non-interlaced PNG")
            bpp = 3 if ctype == 2 else 4
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    stride = w * bpp
    raw = raw.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.int32)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ft, line = raw[y, 0], raw[y, 1:].astype(np.int32)
        cur = np.zeros(stride, np.int32)
        if ft in (0, 2):   # none / up: no dependence along the row
            out[y] = prev = (line + (prev if ft == 2 else 0)) & 0xFF
            continue
        for x in range(stride):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            if ft == 0:
                pred = 0
            elif ft == 1:
                pred = a
            elif ft == 2:
                pred = b
            elif ft == 3:
                pred = (a + b) // 2
            else:
                p = a + b - c
                pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            cur[x] = (line[x] + pred) & 0xFF
        out[y] = cur
        prev = cur
    return out.reshape(h, w, bpp)[..., :3].astype(np.uint8)


def save_ldr(path, img: np.ndarray) -> None:
    """Save a [0,1] float image as 8-bit (values assumed display-ready —
    tonemapping happens upstream, as in the reference's Camera outputs).
    PNG is written by encode_png; other formats need PIL."""
    if str(path).lower().endswith(".png"):
        with open(path, "wb") as f:
            f.write(encode_png(img))
        return
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError(
            f"saving {path}: only .png is written without PIL, which is not "
            f"installed; use a .png or an HDR (.pfm/.exr/.hdr) name") from e
    arr = np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)
    Image.fromarray(arr).save(str(path))


def load_image(path) -> np.ndarray:
    return load_hdr(path) if is_hdr(path) else load_ldr(path)


def save_image(path, img: np.ndarray) -> None:
    if is_hdr(path):
        save_hdr(path, img)
    else:
        save_ldr(path, img)
