"""N-D cartesian process topology — a copy of
``deepspeed_tpu/parallel/topology.py`` (pure Python in both packages).

Plays the role of the reference's ``ProcessTopology`` /
``PipelineParallelGrid``: the rank <-> coordinate math the port's mesh
(``parallel/mesh.py``) builds its process groups from.  An axis here is a
mesh axis name; ``get_axis_comm_lists`` gives the rank sets of one axis's
process groups, ``get_rank_repr`` the checkpoint naming.  Ranks are laid
out row-major, the innermost axis varying fastest.
"""
from __future__ import annotations

from collections import namedtuple
from itertools import product
from typing import Dict, List, Sequence


class ProcessTopology:
    """Maps n-dimensional cartesian coordinates to linear (row-major) ranks."""

    def __init__(self, axes: Sequence[str], dims: Sequence[int]):
        if len(axes) != len(dims):
            raise ValueError("axes and dims must have equal length")
        if len(set(axes)) != len(axes):
            raise ValueError(f"duplicate axis names in {axes}")
        for d in dims:
            if not isinstance(d, int) or d < 1:
                raise ValueError(f"axis dims must be positive ints, got {dims}")
        self.axes = list(axes)
        self.dims = list(dims)
        self.ProcessCoord = namedtuple("ProcessCoord", self.axes)
        self._coord_to_rank: Dict[tuple, int] = {}
        self._rank_to_coord: List[tuple] = []
        for rank, coord in enumerate(product(*(range(d) for d in self.dims))):
            c = self.ProcessCoord(*coord)
            self._coord_to_rank[c] = rank
            self._rank_to_coord.append(c)

    def world_size(self) -> int:
        n = 1
        for d in self.dims:
            n *= d
        return n

    def get_rank(self, **coords) -> int:
        if sorted(coords.keys()) != sorted(self.axes):
            raise ValueError(
                f"get_rank requires all axes {self.axes}, got {list(coords)}")
        return self._coord_to_rank[self.ProcessCoord(**coords)]

    def get_coord(self, rank: int):
        return self._rank_to_coord[rank]

    def get_axis_names(self) -> List[str]:
        return list(self.axes)

    def get_dim(self, axis: str) -> int:
        return self.dims[self.axes.index(axis)]

    def get_rank_repr(self, rank: int, omit_axes=("data",), inner_sep="_",
                      outer_sep="-") -> str:
        """Checkpoint-path naming: e.g. rank → 'pipe_00-model_00'."""
        coord = self.get_coord(rank)
        parts = []
        for ax, idx in zip(self.axes, coord):
            if ax in omit_axes:
                continue
            parts.append(f"{ax}{inner_sep}{idx:02d}")
        return outer_sep.join(parts)

    def get_axis_comm_lists(self, axis: str) -> List[List[int]]:
        """Groups of ranks that vary only along ``axis``: the rank sets of
        that axis's process groups."""
        if axis not in self.axes:
            return []
        other = [a for a in self.axes if a != axis]
        lists = []
        for combo in product(*(range(self.get_dim(a)) for a in other)):
            fixed = dict(zip(other, combo))
            lists.append([self.get_rank(**{axis: i, **fixed})
                          for i in range(self.get_dim(axis))])
        return lists

    def filter_match(self, **filter_kwargs) -> List[int]:
        """All ranks whose coordinates match the given axis=value constraints."""
        def match(rank):
            coord = self.get_coord(rank)
            return all(getattr(coord, ax) == v for ax, v in filter_kwargs.items())
        return [r for r in range(self.world_size()) if match(r)]

    def get_axis_list(self, axis: str, idx: int) -> List[int]:
        return self.filter_match(**{axis: idx})

    def __str__(self):
        return f"ProcessTopology(axes={self.axes}, dims={self.dims})"


class PipeDataParallelTopology(ProcessTopology):
    """2-D pipe × data topology (reference: topology.py:235-243)."""

    def __init__(self, num_pp: int, num_dp: int):
        super().__init__(axes=["pipe", "data"], dims=[num_pp, num_dp])


class PipeModelDataParallelTopology(ProcessTopology):
    """3-D pipe × data × model topology (reference: topology.py:246-249)."""

    def __init__(self, num_pp: int, num_mp: int, num_dp: int):
        super().__init__(axes=["pipe", "data", "model"], dims=[num_pp, num_dp, num_mp])


class ParallelGrid:
    """mpu-style facade over a topology for one SPMD participant.

    The reference's ``PipelineParallelGrid`` (topology.py:252-455 there)
    builds a zoo of torch process groups; here the same queries are answered
    from pure coordinate math, and "group" handles are mesh axis names.
    """

    def __init__(self, topology: ProcessTopology, rank: int = 0):
        self._topo = topology
        self.global_rank = rank
        self.world_size = topology.world_size()

    # --- generic ---
    def _axis_info(self, axis: str):
        if axis in self._topo.axes:
            coord = self._topo.get_coord(self.global_rank)
            return getattr(coord, axis), self._topo.get_dim(axis)
        return 0, 1

    # --- pipe ---
    def get_pipe_parallel_rank(self):
        return self._axis_info("pipe")[0]

    def get_pipe_parallel_world_size(self):
        return self._axis_info("pipe")[1]

    def get_pipe_parallel_group(self):
        return "pipe"

    def get_stage_id(self):
        return self.get_pipe_parallel_rank()

    def is_first_stage(self):
        return self.get_pipe_parallel_rank() == 0

    def is_last_stage(self):
        return self.get_pipe_parallel_rank() == self.get_pipe_parallel_world_size() - 1

    # --- data ---
    def get_data_parallel_rank(self):
        return self._axis_info("data")[0]

    def get_data_parallel_world_size(self):
        return self._axis_info("data")[1]

    def get_data_parallel_group(self):
        return "data"

    # --- model (tensor) ---
    def get_model_parallel_rank(self):
        return self._axis_info("model")[0]

    def get_model_parallel_world_size(self):
        return self._axis_info("model")[1]

    def get_model_parallel_group(self):
        return "model"

    # reference alias: "slice" == model/tensor axis (topology.py:344-364)
    get_slice_parallel_rank = get_model_parallel_rank
    get_slice_parallel_world_size = get_model_parallel_world_size
    get_slice_parallel_group = get_model_parallel_group

    def get_global_rank(self):
        return self.global_rank

    def stage_to_global(self, stage_id: int, **kwargs) -> int:
        """Global rank of the same (data, model) coordinate at another stage."""
        coord = self._topo.get_coord(self.global_rank)
        d = coord._asdict()
        d.update(kwargs)
        d["pipe"] = stage_id
        return self._topo.get_rank(**d)
