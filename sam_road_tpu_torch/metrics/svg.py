"""Debug SVG rendering for TOPO marbles/holes/regions (counterpart of
sam_road_tpu/metrics/svg.py; reference: topo/showTOPO.py:14-155 — mostly
commented-out call sites there; kept as an opt-in debugging surface)."""

from __future__ import annotations


def _svg_header(width=800, height=800):
    return (
        f'<svg xmlns="http://www.w3.org/2000/svg" width="{width}" '
        f'height="{height}" viewBox="0 0 {width} {height}">\n'
        f'<rect width="{width}" height="{height}" fill="white"/>\n'
    )


def _to_px(lat, lon, region, size=800):
    min_lat, min_lon, max_lat, max_lon = region
    x = (lon - min_lon) / max(max_lon - min_lon, 1e-12) * size
    y = size - (lat - min_lat) / max(max_lat - min_lat, 1e-12) * size
    return x, y


def render_region(points, edges, region, filename, size=800):
    """Starting points over graph edges (showTOPO.RenderRegion analog).

    points: [(lat, lon, ...), ...]; edges: [(lat1, lon1, lat2, lon2), ...].
    """
    parts = [_svg_header(size, size)]
    for e in edges:
        x1, y1 = _to_px(e[0], e[1], region, size)
        x2, y2 = _to_px(e[2], e[3], region, size)
        parts.append(
            f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" y2="{y2:.1f}" '
            f'stroke="gray" stroke-width="1"/>\n'
        )
    for p in points:
        x, y = _to_px(p[0], p[1], region, size)
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="3" fill="red"/>\n')
    parts.append("</svg>\n")
    with open(filename, "w") as f:
        f.writelines(parts)


def render_marbles_and_holes(marbles, holes, region, filename, size=800):
    """Marble (proposal) vs hole (GT) overlay (showTOPO.RenderSVG analog)."""
    parts = [_svg_header(size, size)]
    for h in holes:
        x, y = _to_px(h[0], h[1], region, size)
        parts.append(
            f'<circle cx="{x:.1f}" cy="{y:.1f}" r="4" fill="none" '
            f'stroke="blue" stroke-width="1"/>\n'
        )
    for m in marbles:
        x, y = _to_px(m[0], m[1], region, size)
        parts.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2" fill="red"/>\n')
    parts.append("</svg>\n")
    with open(filename, "w") as f:
        f.writelines(parts)
