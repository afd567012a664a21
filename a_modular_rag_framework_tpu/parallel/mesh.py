"""Device mesh construction.

The reference has no parallelism of any kind (SURVEY.md §2b); this module is
the new-design obligation: a `jax.sharding.Mesh` over the host's devices,
with the corpus sharded over the ``data`` axis and model weights optionally
sharded over ``model``. The cards of one host are joined all to all, so
every device pair costs the same and the mesh's shape follows the
algorithm alone: axis order carries no topology.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh


def build_mesh(
    axis_sizes: Optional[Dict[str, int]] = None,
    *,
    devices: Optional[Sequence[Any]] = None,
) -> Mesh:
    """Build a mesh from ``{axis: size}`` where one size may be -1 (fill).

    Default: all devices on a single ``data`` axis.
    """
    devs = list(devices if devices is not None else jax.devices())
    n = len(devs)
    axes = dict(axis_sizes or {"data": -1})

    fixed = 1
    fill_axis = None
    for name, size in axes.items():
        if size == -1:
            if fill_axis is not None:
                raise ValueError("only one axis may be -1")
            fill_axis = name
        else:
            fixed *= int(size)
    if fill_axis is not None:
        if n % fixed:
            raise ValueError(f"{n} devices not divisible by fixed axes {axes}")
        axes[fill_axis] = n // fixed
    total = int(np.prod(list(axes.values())))
    if total != n:
        raise ValueError(f"mesh {axes} needs {total} devices, have {n}")

    names = tuple(axes.keys())
    shape = tuple(axes[a] for a in names)
    return Mesh(np.array(devs).reshape(shape), names)


def mesh_from_settings(settings: Dict[str, Any]) -> Mesh:
    """Mesh from the settings ``mesh:`` section.

    ``dcn_axes`` compose OUTERMOST as query-data-parallel axes: the index
    is replicated across them and the query batch splits over them, so
    every collective of the retrieval program names only the inner
    ``axes``. Leave it empty to shard the index over every device.
    """
    mesh_cfg = settings.get("mesh") or {}
    axes = dict(mesh_cfg.get("axes") or {"data": -1})
    dcn = dict(mesh_cfg.get("dcn_axes") or {})
    merged = {**dcn, **axes}  # dict order: dcn axes first = outermost
    if set(dcn) & set(axes):
        raise ValueError(f"dcn_axes and axes share names: {set(dcn) & set(axes)}")
    return build_mesh(merged)
