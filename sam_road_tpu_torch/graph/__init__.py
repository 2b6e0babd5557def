"""Host-side road-graph library of the PyTorch port (counterpart of
sam_road_tpu/graph/, with the same public names): array-backed graphs, grid
spatial indexes, exact segment geometry, greedy point NMS (C++), the
sat2graph converters, the large-map merge operators and polyline tracing.
"""

from sam_road_tpu_torch.graph.structure import (
    ArrayGraph,
    graph_from_adj_dict,
    subdivide_graph,
    bfs_with_conditions,
)
from sam_road_tpu_torch.graph.spatial import PointGridIndex, RectGridIndex
from sam_road_tpu_torch.graph.geometry import (
    segments_intersect,
    find_crossover_points,
    point_segment_distance,
)
from sam_road_tpu_torch.graph.nms import nms_points
from sam_road_tpu_torch.graph.convert import (
    convert_to_sat2graph_format,
    convert_from_sat2graph_format,
    convert_from_nx,
    edge_list_to_adj_table,
    filter_nodes,
)
from sam_road_tpu_torch.graph.merge import (
    remove_isolate_nodes,
    merge_nodes,
    split_edges,
    combine_graphs,
    merge_into_large_graph,
)
from sam_road_tpu_torch.graph.polylines import (
    trace_segment,
    find_segments_in_road_graph,
    normalize_segments,
    get_resampled_polylines,
    get_polylines_from_road_graph,
    get_polyline_connectivity,
)

__all__ = [
    "ArrayGraph",
    "graph_from_adj_dict",
    "subdivide_graph",
    "bfs_with_conditions",
    "PointGridIndex",
    "RectGridIndex",
    "segments_intersect",
    "find_crossover_points",
    "point_segment_distance",
    "nms_points",
    "convert_to_sat2graph_format",
    "convert_from_sat2graph_format",
    "convert_from_nx",
    "edge_list_to_adj_table",
    "filter_nodes",
    "remove_isolate_nodes",
    "merge_nodes",
    "split_edges",
    "combine_graphs",
    "merge_into_large_graph",
    "trace_segment",
    "find_segments_in_road_graph",
    "normalize_segments",
    "get_resampled_polylines",
    "get_polylines_from_road_graph",
    "get_polyline_connectivity",
]
