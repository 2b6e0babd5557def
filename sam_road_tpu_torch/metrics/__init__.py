"""Road-graph metric suite: APLS and TOPO (counterpart of
sam_road_tpu/metrics/).

Behavioral port of the reference's cityscale_metrics/ + spacenet_metrics/
(Go APLS scorer + Python TOPO scorer), preserving their idiosyncrasies
(duplicate-marble bidirection hack, 1.0 penalty for unmatched APLS pairs,
cross-graph coverage propagation) so scores are comparable. Host code only:
numpy, scipy's cKDTree and the shared native/apls.cc (an executable) and
native/topo.cc (a ctypes library), built at first use; a failed build
raises. This package imports neither torch nor jax, so the runner's worker
processes carry no device state.
"""

from sam_road_tpu_torch.metrics.latlon import xy2latlon, gps_distance
from sam_road_tpu_torch.metrics.topo_graph import TopoGraph, create_graph_from_adj
from sam_road_tpu_torch.metrics.topo import (
    TOPOGenerateStartingPoints,
    TOPOGeneratePairs,
    TOPOWithPairs,
    topo_score_one_tile,
)
from sam_road_tpu_torch.metrics.apls import apls_score, sat2graph_to_apls_json

__all__ = [
    "xy2latlon",
    "gps_distance",
    "TopoGraph",
    "create_graph_from_adj",
    "TOPOGenerateStartingPoints",
    "TOPOGeneratePairs",
    "TOPOWithPairs",
    "topo_score_one_tile",
    "apls_score",
    "sat2graph_to_apls_json",
]
