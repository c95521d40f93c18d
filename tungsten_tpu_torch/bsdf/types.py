"""BSDF type enums and the parameter-table layout (port of
tungsten_tpu/bsdf/types.py).

The scene flattener packs every BSDF into one SoA table row:
  bsdf_type   : int32 enum (below; ids equal the JAX package's)
  albedo_tex  : texture index
  params      : (NUM_PARAMS,) float32 — slot meanings in `P`
  aux         : (NUM_AUX,) int32 — child indices, microfacet
                distribution enum, ratio-texture index
The port evaluates every type of the JAX package (PORTED_TYPES): the
surface BSDFs, the forward-lobe types thinsheet, transparency and
forward, and the fiber BCSDFs hair, rough_wire and lambertian_fiber
(bsdf/fiber.py).
"""
from __future__ import annotations

import numpy as np

LAMBERT = 0
NULL = 1
MIRROR = 2
CONDUCTOR = 3
ROUGH_CONDUCTOR = 4
DIELECTRIC = 5
ROUGH_DIELECTRIC = 6
PLASTIC = 7
ROUGH_PLASTIC = 8
OREN_NAYAR = 9
PHONG = 10
THINSHEET = 11
SMOOTH_COAT = 12
ROUGH_COAT = 13
MIXED = 14
TRANSPARENCY = 15
FORWARD = 16
DIFFUSE_TRANSMISSION = 17
LAMBERTIAN_FIBER = 18
ROUGH_WIRE = 19
HAIR = 20
ERROR = 21

NAME_TO_TYPE = {
    "lambert": LAMBERT,
    "null": NULL,
    "mirror": MIRROR,
    "conductor": CONDUCTOR,
    "rough_conductor": ROUGH_CONDUCTOR,
    "dielectric": DIELECTRIC,
    "rough_dielectric": ROUGH_DIELECTRIC,
    "plastic": PLASTIC,
    "rough_plastic": ROUGH_PLASTIC,
    "oren_nayar": OREN_NAYAR,
    "phong": PHONG,
    "thinsheet": THINSHEET,
    "smooth_coat": SMOOTH_COAT,
    "rough_coat": ROUGH_COAT,
    "mixed": MIXED,
    "transparency": TRANSPARENCY,
    "forward": FORWARD,
    "diffuse_transmission": DIFFUSE_TRANSMISSION,
    "lambertian_fiber": LAMBERTIAN_FIBER,
    "rough_wire": ROUGH_WIRE,
    "hair": HAIR,
}

# the types this port evaluates (bsdf/eval.py)
PORTED_TYPES = (LAMBERT, NULL, MIRROR, CONDUCTOR, ROUGH_CONDUCTOR,
                DIELECTRIC, ROUGH_DIELECTRIC, PLASTIC, ROUGH_PLASTIC,
                OREN_NAYAR, PHONG, THINSHEET, SMOOTH_COAT, ROUGH_COAT,
                MIXED, TRANSPARENCY, FORWARD, DIFFUSE_TRANSMISSION,
                LAMBERTIAN_FIBER, ROUGH_WIRE, HAIR)
# the forward-lobe types: a path may pass straight through them, which
# takes the path tracer off its one-sample-MIS estimator
FORWARD_LOBE_TYPES = (THINSHEET, TRANSPARENCY, FORWARD)

DIST_BECKMANN = 0
DIST_PHONG = 1
DIST_GGX = 2
DIST_NAMES = {"beckmann": DIST_BECKMANN, "phong": DIST_PHONG, "ggx": DIST_GGX}


class P:
    """params[] slot layout (float32)."""
    IOR = 0
    ROUGHNESS = 1
    ETA_R = 2
    ETA_G = 3
    ETA_B = 4
    K_R = 5
    K_G = 6
    K_B = 7
    SIGMA_A_R = 8
    SIGMA_A_G = 9
    SIGMA_A_B = 10
    THICKNESS = 11
    EXTRA0 = 12
    EXTRA1 = 13
    EXTRA2 = 14
    EXTRA3 = 15


NUM_PARAMS = 16


class AUX:
    """aux[] slot layout (int32)."""
    DISTRIBUTION = 0
    CHILD0 = 1
    CHILD1 = 2
    RATIO_TEX = 3


NUM_AUX = 4


# Measured complex IORs (eta, k) at RGB primaries for named metals.
# Physical constants from refractiveindex.info-style spectral data, the
# same standard table the reference ships (src/core/bsdfs/ComplexIorData.hpp).
COMPLEX_IOR = {
    "a-C": ((2.9440999183, 2.2271502925, 1.9681668794), (0.8874329109, 0.7993216383, 0.8152862927)),
    "Ag": ((0.1552646489, 0.1167232965, 0.1383806959), (4.8283433224, 3.1222459278, 2.1469504455)),
    "Al": ((1.6574599595, 0.8803689579, 0.5212287346), (9.2238691996, 6.2695232477, 4.8370012281)),
    "AlAs": ((3.6051023902, 3.2329365777, 2.2175611545), (0.0006670247, -0.0004999400, 0.0074261204)),
    "AlSb": ((-0.0485225705, 4.1427547893, 4.6697691348), (-0.0363741915, 0.0937665154, 1.3007390124)),
    "Au": ((0.1431189557, 0.3749570432, 1.4424785571), (3.9831604247, 2.3857207478, 1.6032152899)),
    "Be": ((4.1850592788, 3.1850604423, 2.7840913457), (3.8354398268, 3.0101260162, 2.8690088743)),
    "Cr": ((4.3696828663, 2.9167024892, 1.6547005413), (5.2064337956, 4.2313645277, 3.7549467933)),
    "CsI": ((2.1449030413, 1.7023164587, 1.6624194173), (0.0, 0.0, 0.0)),
    "Cu": ((0.2004376970, 0.9240334304, 1.1022119527), (3.9129485033, 2.4528477015, 2.1421879552)),
    "Cu2O": ((3.5492833755, 2.9520622449, 2.7369202137), (0.1132179294, 0.1946659670, 0.6001681264)),
    "CuO": ((3.2453822204, 2.4496293965, 2.1974114493), (0.5202739621, 0.5707372756, 0.7172250613)),
    "d-C": ((2.7112524747, 2.3185812849, 2.2288565009), (0.0, 0.0, 0.0)),
    "Hg": ((2.3989314904, 1.4400254917, 0.9095512090), (6.3276269444, 4.3719414152, 3.4217899270)),
    "HgTe": ((4.7795267752, 3.2309984581, 2.6600252401), (1.6319827058, 1.5808189339, 1.7295753852)),
    "Ir": ((3.0864098394, 2.0821938440, 1.6178866805), (5.5921510077, 4.0671757150, 3.2672611269)),
    "K": ((0.0640493070, 0.0464100621, 0.0381842017), (2.1042155920, 1.3489364357, 0.9132113889)),
    "Li": ((0.2657871942, 0.1956102432, 0.2209198538), (3.5401743407, 2.3111306542, 1.6685930000)),
    "MgO": ((2.0895885542, 1.6507224525, 1.5948759692), (0.0, 0.0, 0.0)),
    "Mo": ((4.4837010280, 3.5254578255, 2.7760769438), (4.1111307988, 3.4208716252, 3.1506031404)),
    "Na": ((0.0602665320, 0.0561412435, 0.0619909494), (3.1792906496, 2.1124800781, 1.5790940266)),
    "Nb": ((3.4201353595, 2.7901921379, 2.3955856658), (3.4413817900, 2.7376437930, 2.5799132708)),
    "Ni": ((2.3672753521, 1.6633583302, 1.4670554172), (4.4988329911, 3.0501643957, 2.3454274399)),
    "Rh": ((2.5857954933, 1.8601866068, 1.5544279524), (6.7822927110, 4.7029501026, 3.9760892461)),
    "Se-e": ((5.7242724833, 4.1653992967, 4.0816099264), (0.8713747439, 1.1052845009, 1.5647788766)),
    "Se": ((4.0592611085, 2.8426947380, 2.8207582835), (0.7543791750, 0.6385150558, 0.5215872029)),
    "SiC": ((3.1723450205, 2.5259677964, 2.4793623897), (0.0000007284, -0.0000006859, 0.0000100150)),
    "SnTe": ((4.5251865890, 1.9811525984, 1.2816819226), (0.0, 0.0, 0.0)),
    "Ta": ((2.0625846607, 2.3930915569, 2.6280684948), (2.4080467973, 1.7413705864, 1.9470377016)),
    "Te-e": ((7.5090397678, 4.2964603080, 2.3698732430), (5.5842076830, 4.9476231084, 3.9975145063)),
    "Te": ((7.3908396088, 4.4821028985, 2.6370708478), (3.2561412892, 3.5273908133, 3.2921683116)),
    "ThF4": ((1.8307187117, 1.4422274283, 1.3876488528), (0.0, 0.0, 0.0)),
    "TiC": ((3.7004673762, 2.8374356509, 2.5823030278), (3.2656905818, 2.3515586388, 2.1727857800)),
    "TiN": ((1.6484691607, 1.1504482522, 1.3797795097), (3.3684596226, 1.9434888540, 1.1020123347)),
    "TiO2-e": ((3.1065574823, 2.5131551146, 2.5823844157), (0.0000289537, -0.0000251484, 0.0001775555)),
    "TiO2": ((3.4566203131, 2.8017076558, 2.9051485020), (0.0001026662, -0.0000897534, 0.0006356902)),
    "VC": ((3.6575665991, 2.7527298065, 2.5326814570), (3.0683516659, 2.1986687713, 1.9631816252)),
    "VN": ((2.8656011588, 2.1191817791, 1.9400767149), (3.0323264950, 2.0561075580, 1.6162930914)),
    "V": ((4.2775126218, 3.5131538236, 2.7611257461), (3.4911844504, 2.8893580874, 3.1116965117)),
    "W": ((4.3707029924, 3.3002972445, 2.9982666528), (3.5006778591, 2.6048652781, 2.2731930614)),
}


def parse_bsdf_row(b: dict, textures, fiber_tables: list | None = None
                   ) -> tuple[int, int, np.ndarray, np.ndarray]:
    """One scene-JSON bsdf dict -> (type, albedo_tex, params, aux), laid
    out exactly as the JAX package lays out the row.  `textures` is a
    TextureTableBuilder; texture-valued fields register there.
    `fiber_tables` collects the precomputed hair azimuthal tables (one
    dict per hair BSDF); aux[CHILD0] holds the table index."""
    name = b.get("type", "lambert")
    t = NAME_TO_TYPE.get(name, ERROR)
    if t not in PORTED_TYPES:
        ported = ", ".join(n for n, v in NAME_TO_TYPE.items()
                           if v in PORTED_TYPES)
        raise NotImplementedError(
            f"tungsten_tpu_torch: bsdf type {name!r} is not ported yet "
            f"(ported: {ported})")
    params = np.zeros(NUM_PARAMS, np.float32)
    aux = np.full(NUM_AUX, -1, np.int32)
    aux[AUX.DISTRIBUTION] = DIST_NAMES.get(b.get("distribution", "ggx"),
                                           DIST_GGX)
    albedo_tex = textures.add(b.get("albedo", 1.0))
    params[P.IOR] = float(b.get("ior", 1.5))
    rough = b.get("roughness", 0.1)
    if isinstance(rough, (dict, str)):
        aux[AUX.RATIO_TEX] = textures.add(rough)
        params[P.ROUGHNESS] = -1.0  # signals textured roughness
    else:
        params[P.ROUGHNESS] = float(rough)

    if t in (CONDUCTOR, ROUGH_CONDUCTOR, ROUGH_WIRE):
        if "material" in b:
            eta, k = COMPLEX_IOR[b["material"]]
        else:
            eta = b.get("eta", (0.2004, 0.9240, 1.1022))
            k = b.get("k", (3.9129, 2.4528, 2.1421))
            if isinstance(eta, (int, float)):
                eta = (eta,) * 3
            if isinstance(k, (int, float)):
                k = (k,) * 3
        params[P.ETA_R:P.ETA_B + 1] = eta
        params[P.K_R:P.K_B + 1] = k

    if t == HAIR:
        from tungsten_tpu_torch.bsdf import fiber
        lobe_params, beta_r = fiber.hair_lobe_params(b)
        params[P.EXTRA0:P.EXTRA3 + 1] = lobe_params
        if fiber_tables is not None:
            aux[AUX.CHILD0] = len(fiber_tables)
            fiber_tables.append(dict(
                fiber.precompute_hair_azimuthal(fiber.hair_sigma_a(b),
                                                beta_r),
                params=lobe_params))
        else:
            aux[AUX.CHILD0] = 0

    sigma_a = b.get("sigma_a", 0.0)
    if isinstance(sigma_a, (int, float)):
        sigma_a = (sigma_a,) * 3
    params[P.SIGMA_A_R:P.SIGMA_A_B + 1] = sigma_a
    params[P.THICKNESS] = float(b.get("thickness", 1.0))

    if t == PHONG:
        params[P.EXTRA0] = float(b.get("exponent", 64.0))
        params[P.EXTRA1] = float(b.get("diffuse_ratio", 0.2))
    if t in (DIELECTRIC, ROUGH_DIELECTRIC):
        params[P.EXTRA0] = 1.0 if b.get("enable_refraction", True) else 0.0
    if t == THINSHEET:
        params[P.EXTRA0] = 1.0 if b.get("enable_interference", False) else 0.0
    if t in (PLASTIC, ROUGH_PLASTIC, SMOOTH_COAT, ROUGH_COAT):
        from tungsten_tpu_torch.bsdf.fresnel import compute_diffuse_fresnel
        params[P.EXTRA0] = compute_diffuse_fresnel(params[P.IOR])
        scaled = params[P.THICKNESS] * params[P.SIGMA_A_R:P.SIGMA_A_B + 1]
        params[P.EXTRA1] = float(np.exp(-2.0 * scaled.mean()))
        # rough_plastic scales its substrate probability by avg albedo
        alb = b.get("albedo", 1.0)
        if isinstance(alb, (int, float)):
            avg_alb = float(alb)
        elif isinstance(alb, (list, tuple)):
            avg_alb = float(np.mean(alb))
        else:
            avg_alb = 0.7  # textured albedo: rough average (sampling-only)
        params[P.EXTRA2] = avg_alb if t == ROUGH_PLASTIC else 1.0
    if t == MIXED:
        aux[AUX.RATIO_TEX] = textures.add(b.get("ratio", 0.5))
        aux[AUX.CHILD0] = int(b.get("bsdf0_index", -1))
        aux[AUX.CHILD1] = int(b.get("bsdf1_index", -1))
    if t in (SMOOTH_COAT, ROUGH_COAT):
        aux[AUX.CHILD0] = int(b.get("substrate_index", -1))
    if t == TRANSPARENCY:
        aux[AUX.CHILD0] = int(b.get("base_index", -1))
        aux[AUX.RATIO_TEX] = textures.add(b.get("alpha", 1.0))
    if t == DIFFUSE_TRANSMISSION:
        params[P.EXTRA0] = float(b.get("transmittance", 0.5))
    return t, albedo_tex, params, aux
