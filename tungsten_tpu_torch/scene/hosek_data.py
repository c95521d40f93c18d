"""Hosek-Wilkie RGB sky-model coefficient dataset (port of
tungsten_tpu/scene/hosek_data.py).

The fitted coefficients come from the public Hosek & Wilkie 2012 "An
Analytic Model for Full Spectral Sky-Dome Radiance" reference
implementation (BSD-licensed research data, ArHosekSkyModelData_RGB.h).
They are published model constants, data and not code; scene/sky.py
evaluates them.  The port reads its own copy, `hosek_rgb.npz` beside
this module.  Layout per channel: configs (2 albedos, 10 turbidities,
6 elevation-bezier knots, 9 params) and radiance (2, 10, 6).
"""
from __future__ import annotations

import functools
import os

import numpy as np

DATASET = os.path.join(os.path.dirname(__file__), "hosek_rgb.npz")


@functools.lru_cache(maxsize=1)
def load_dataset():
    """Returns (configs (3,2,10,6,9), radiance (3,2,10,6)), float64."""
    with np.load(DATASET) as d:
        return d["configs"], d["radiance"]
