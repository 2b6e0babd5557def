"""Fake-latlon projection + distance helpers shared by APLS and TOPO
(counterpart of sam_road_tpu/metrics/latlon.py).

The reference projects pixel (r, c) coordinates onto a fictitious lat/lon
frame anchored at (41, -71) (reference: cityscale_metrics/apls/convert.py:
8-15, topo/main.py:56-60) so the metric code can use degree-based thresholds.
"""

from __future__ import annotations

import math

LAT_TOP_LEFT = 41.0
LON_TOP_LEFT = -71.0


def xy2latlon(x: float, y: float):
    """Pixel (r, c) -> fake (lat, lon) (reference: topo/main.py:56-60)."""
    lat = LAT_TOP_LEFT - x * 1.0 / 111111.0
    lon = LON_TOP_LEFT + (y * 1.0 / 111111.0) / math.cos(math.radians(LAT_TOP_LEFT))
    return lat, lon


def distance(p1, p2):
    """Cos-scaled degree distance (reference: topo/graph.py:15-18)."""
    a = p1[0] - p2[0]
    b = (p1[1] - p2[1]) * math.cos(math.radians(p1[0]))
    return math.sqrt(a * a + b * b)


def gps_distance(p1, p2):
    """Meter distance (reference: apls/main.go:72-77)."""
    a = (p1[0] - p2[0]) * 111111.0
    b = (p1[1] - p2[1]) * 111111.0 * math.cos(p1[0] / 360.0 * 2.0 * math.pi)
    return math.sqrt(a * a + b * b)


def latlon_norm(p1, lat: float = 40):
    """Unit direction vector with cos scaling (reference: topo/topo.py:16-22)."""
    p11 = p1[1] * math.cos(math.radians(lat))
    l = math.sqrt(p11 * p11 + p1[0] * p1[0])
    return p1[0] / l, p11 / l


def point_to_line_distance_latlon(p1, p2, p3):
    """Distance from p3 to segment p1->p2 in the cos-scaled frame
    (reference: topo/topo.py:24-67)."""
    pp2 = (
        p2[0] - p1[0],
        (p2[1] - p1[1]) * math.cos(math.radians(p1[0])),
    )
    pp3 = (
        p3[0] - p1[0],
        (p3[1] - p1[1]) * math.cos(math.radians(p1[0])),
    )
    dist = math.sqrt(pp2[0] * pp2[0] + pp2[1] * pp2[1])
    proj_length = (pp2[0] * pp3[0] + pp2[1] * pp3[1]) / dist
    if proj_length > dist:
        a = pp3[0] - pp2[0]
        b = pp3[1] - pp2[1]
        return math.sqrt(a * a + b * b)
    if proj_length < 0:
        return math.sqrt(pp3[0] * pp3[0] + pp3[1] * pp3[1])
    alpha = proj_length / dist
    a = pp3[0] - alpha * pp2[0]
    b = pp3[1] - alpha * pp2[1]
    return math.sqrt(a * a + b * b)
