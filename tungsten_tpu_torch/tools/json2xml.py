"""Scene JSON -> Mitsuba XML converter (ref src/json2xml/
JsonXmlConverter.hpp): bsdfs, primitives, camera, integrator.  Mesh
primitives referencing .wo3 files are re-exported as .obj next to the
output (Mitsuba cannot read wo3), mirroring the reference's wo3->obj
conversion.

The port's own copy of tungsten_tpu/tools/json2xml.py, on the port's io/
and scene/.
"""
from __future__ import annotations

import os
import xml.etree.ElementTree as ET
from xml.dom import minidom

import numpy as np

from tungsten_tpu_torch.scene import transform as xform
from tungsten_tpu_torch.scene.parse import load_scene

_BSDF_MAP = {
    "lambert": "diffuse",
    "oren_nayar": "roughdiffuse",
    "phong": "phong",
    "dielectric": "dielectric",
    "thinsheet": "thindielectric",
    "mirror": "conductor",
    "plastic": "plastic",
    "rough_plastic": "roughplastic",
    "conductor": "conductor",
    "rough_conductor": "roughconductor",
    "rough_dielectric": "roughdielectric",
    "smooth_coat": "coating",
    "rough_coat": "coating",
    "null": "diffuse",
    "forward": "diffuse",
    "transparency": "mask",
    "mixed": "blendbsdf",
}


def _rgb(el, name, v):
    if isinstance(v, (int, float)):
        v = (v, v, v)
    ET.SubElement(el, "rgb", name=name,
                  value=", ".join(f"{float(x):g}" for x in v[:3]))


def _flt(el, name, v):
    ET.SubElement(el, "float", name=name, value=f"{float(v):g}")


def _spectrum_or_texture(el, name, v):
    if isinstance(v, dict):  # texture: only bitmaps translate
        if v.get("type") == "bitmap" or "file" in v:
            t = ET.SubElement(el, "texture", name=name, type="bitmap")
            ET.SubElement(t, "string", name="filename",
                          value=str(v.get("file", "")))
        else:
            _rgb(el, name, 0.5)
    else:
        _rgb(el, name, v)


def _convert_bsdf(b: dict) -> ET.Element:
    ty = b.get("type", "lambert")
    el = ET.Element("bsdf", type=_BSDF_MAP.get(ty, "diffuse"))
    if b.get("name"):
        el.set("id", b["name"])
    albedo = b.get("albedo", 1.0)
    if ty in ("lambert", "oren_nayar", "null", "forward"):
        _spectrum_or_texture(el, "reflectance", albedo)
        if ty == "oren_nayar":
            _flt(el, "alpha", b.get("roughness", 0.1))
    elif ty in ("conductor", "rough_conductor", "mirror"):
        if "material" in b:
            ET.SubElement(el, "string", name="material",
                          value=b["material"])
        if ty == "rough_conductor":
            _flt(el, "alpha", b.get("roughness", 0.1))
        _spectrum_or_texture(el, "specularReflectance", albedo)
    elif ty in ("dielectric", "rough_dielectric", "thinsheet"):
        _flt(el, "intIOR", b.get("ior", 1.5))
        if ty == "rough_dielectric":
            _flt(el, "alpha", b.get("roughness", 0.1))
    elif ty in ("plastic", "rough_plastic"):
        _flt(el, "intIOR", b.get("ior", 1.5))
        _spectrum_or_texture(el, "diffuseReflectance", albedo)
        if ty == "rough_plastic":
            _flt(el, "alpha", b.get("roughness", 0.1))
    elif ty in ("smooth_coat", "rough_coat"):
        _flt(el, "intIOR", b.get("ior", 1.3))
        sub = b.get("substrate")
        if isinstance(sub, dict):
            el.append(_convert_bsdf(sub))
    elif ty == "transparency":
        _spectrum_or_texture(el, "opacity", b.get("alpha", 1.0))
        base = b.get("base")
        if isinstance(base, dict):
            el.append(_convert_bsdf(base))
    elif ty == "mixed":
        _flt(el, "weight", b.get("ratio", 0.5)
             if isinstance(b.get("ratio", 0.5), (int, float)) else 0.5)
        for key in ("bsdf0", "bsdf1"):
            c = b.get(key)
            if isinstance(c, dict):
                el.append(_convert_bsdf(c))
            elif isinstance(c, str):
                ET.SubElement(el, "ref", id=c)
    elif ty == "phong":
        _flt(el, "exponent", b.get("exponent", 64.0))
        _spectrum_or_texture(el, "diffuseReflectance", albedo)
    return el


def _matrix_el(parent, m: np.ndarray):
    t = ET.SubElement(parent, "transform", name="toWorld")
    ET.SubElement(t, "matrix", value=" ".join(
        f"{float(x):g}" for x in np.asarray(m, np.float64).reshape(-1)))


_SHAPE_MAP = {"quad": "rectangle", "cube": "cube", "sphere": "sphere",
              "disk": "disk", "mesh": "obj", "curves": "hair"}


def _convert_primitive(p: dict, bsdf_names: dict, scene_dir: str,
                       out_dir: str) -> ET.Element | None:
    ty = p.get("type", "mesh")
    if ty == "infinite_sphere":
        el = ET.Element("emitter", type="envmap")
        em = p.get("emission")
        if isinstance(em, dict) and "file" in em:
            ET.SubElement(el, "string", name="filename", value=em["file"])
        elif isinstance(em, str):
            ET.SubElement(el, "string", name="filename", value=em)
        return el
    if ty == "infinite_sphere_cap":
        el = ET.Element("emitter", type="sun")
        return el
    if ty == "skydome":
        el = ET.Element("emitter", type="sky")
        _flt(el, "turbidity", p.get("turbidity", 3.0))
        return el
    if ty == "point":
        el = ET.Element("emitter", type="point")
        m = xform.parse_transform(p.get("transform"))
        pos = xform.transform_point(m, [0, 0, 0])
        ET.SubElement(el, "point", name="position", x=f"{pos[0]:g}",
                      y=f"{pos[1]:g}", z=f"{pos[2]:g}")
        _rgb(el, "intensity", p.get("emission", p.get("power", 1.0)))
        return el
    if ty not in _SHAPE_MAP:
        return None
    el = ET.Element("shape", type=_SHAPE_MAP[ty])
    if ty == "mesh":
        fname = str(p.get("file", ""))
        if fname.lower().endswith(".wo3"):
            # Mitsuba cannot read wo3: re-export as obj (ref wo3->obj)
            from tungsten_tpu_torch.io import mesh as mesh_io
            m = mesh_io.load_mesh(os.path.join(scene_dir, fname))
            out_obj = os.path.splitext(os.path.basename(fname))[0] + ".obj"
            mesh_io.save_obj(os.path.join(out_dir, out_obj), m)
            fname = out_obj
        ET.SubElement(el, "string", name="filename", value=fname)
    if ty == "curves":
        ET.SubElement(el, "string", name="filename",
                      value=str(p.get("file", "")))
        _flt(el, "radius", p.get("curve_thickness", 0.01))
    m = xform.parse_transform(p.get("transform"))
    _matrix_el(el, np.vstack([m, [0, 0, 0, 1]])
               if m.shape == (3, 4) else m)
    bsdf = p.get("bsdf")
    if isinstance(bsdf, str) and bsdf in bsdf_names:
        ET.SubElement(el, "ref", id=bsdf)
    elif isinstance(bsdf, dict):
        el.append(_convert_bsdf(bsdf))
    if p.get("emission") is not None and ty in _SHAPE_MAP:
        area = ET.SubElement(el, "emitter", type="area")
        _rgb(area, "radiance", p.get("emission"))
    return el


def convert(scene_path: str, out_path: str) -> None:
    desc = load_scene(scene_path)
    raw = desc.json
    root = ET.Element("scene", version="0.5.0")

    integ = raw.get("integrator", {})
    integ_el = ET.SubElement(root, "integrator", type="path")
    ET.SubElement(integ_el, "integer", name="maxDepth",
                  value=str(integ.get("max_bounces", 64)))

    cam = raw.get("camera", {})
    sensor = ET.SubElement(
        root, "sensor",
        type={"pinhole": "perspective", "thinlens": "thinlens",
              "equirectangular": "spherical"}.get(
                  cam.get("type", "pinhole"), "perspective"))
    _flt(sensor, "fov", cam.get("fov", 60.0))
    m = xform.parse_transform(cam.get("transform"))
    m4 = np.vstack([m, [0, 0, 0, 1]]) if m.shape == (3, 4) else m
    _matrix_el(sensor, m4)
    res = cam.get("resolution", [512, 512])
    if isinstance(res, (int, float)):
        res = [res, res]
    film = ET.SubElement(sensor, "film", type="hdrfilm")
    ET.SubElement(film, "integer", name="width", value=str(int(res[0])))
    ET.SubElement(film, "integer", name="height", value=str(int(res[1])))
    sampler = ET.SubElement(sensor, "sampler", type="sobol")
    ET.SubElement(sampler, "integer", name="sampleCount",
                  value=str(raw.get("renderer", {}).get("spp", 32)))

    bsdf_names = {}
    for b in raw.get("bsdfs", []):
        if b.get("name"):
            bsdf_names[b["name"]] = b
            root.append(_convert_bsdf(b))
    scene_dir = os.path.dirname(os.path.abspath(scene_path))
    out_dir = os.path.dirname(os.path.abspath(out_path)) or "."
    for p in raw.get("primitives", []):
        el = _convert_primitive(p, bsdf_names, scene_dir, out_dir)
        if el is not None:
            root.append(el)

    pretty = minidom.parseString(
        ET.tostring(root, encoding="unicode")).toprettyxml(indent="    ")
    with open(out_path, "w") as f:
        f.write(pretty)


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="Convert a Tungsten scene JSON to Mitsuba XML")
    ap.add_argument("scene")
    ap.add_argument("output", nargs="?", default=None)
    args = ap.parse_args(argv)
    out = args.output or os.path.splitext(args.scene)[0] + ".xml"
    convert(args.scene, out)
    print(f"wrote {out}")


if __name__ == "__main__":
    main()
