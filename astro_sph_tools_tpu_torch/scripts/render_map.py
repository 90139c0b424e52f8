"""Snapshot loading for the command-line tools.

Counterpart: ``astro_sph_tools_tpu/scripts/render_map.py``. Only
:func:`load_snapshot` is ported so far; the render CLI itself is ROADMAP
queue 1, item 5.
"""

from __future__ import annotations


def load_snapshot(path: str, fmt: str):
    """Open the snapshot at ``path`` in format ``fmt`` (eagle | swift | tng)."""
    if fmt == "eagle":
        from ..io.eagle import SnapshotEAGLE

        return SnapshotEAGLE(path)
    if fmt in ("swift", "tng"):
        raise NotImplementedError(
            f"the {fmt} reader is not ported to astro_sph_tools_tpu_torch yet "
            "(ROADMAP queue 1, item 5)"
        )
    raise SystemExit(f"error: unknown snapshot format {fmt!r}")
