"""Deterministic segment sums.

A float scatter-add on CUDA (``index_add_``, ``index_put_`` with
``accumulate=True`` outside deterministic mode) adds with atomics, in an
order, and so with a rounding, that changes from run to run. The sums here
add in a fixed order on every device, without touching the host:

- ids that are already sorted (the voxel runs of ops/voxel.py) are summed
  run by run with ``torch.segment_reduce``: each output slot adds its run
  from first to last, the order ``index_add_`` takes on the CPU, so the
  CPU result is bitwise that of ``index_add_``;
- unsorted ids (the edge tables of the graph solve) go through
  ``index_put_(accumulate=True)``, which sorts them and adds each slot's
  values in a fixed order only under ``deterministic()``: the caller owns
  that switch (graph/solver.py:optimize_se2 holds it around the whole
  solve, whose other scatter-adds need it too).
"""

import torch

from ..utils.device import ProcessSwitch


def _get_deterministic():
    return (torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled())


def _put_deterministic(value):
    torch.use_deterministic_algorithms(value[0], warn_only=value[1])


_DETERMINISTIC = ProcessSwitch(_get_deterministic, _put_deterministic, (True, False))


def deterministic():
    """Run the enclosed code with torch's deterministic algorithms: the
    float scatter-adds take the sort-based CUDA kernel instead of atomics,
    whose order (and so the rounding of the sum) changes from run to run,
    and LM's accept/reject near convergence sits on that rounding.

    The setting is process state: it holds while any thread is inside
    (utils/device.py:ProcessSwitch), and the threaded runner's workers hold
    it for their whole life, so an op run on another thread meets the same
    setting whenever a solve starts or ends."""
    return _DETERMINISTIC.hold()


def _get_fill():
    return torch.utils.deterministic.fill_uninitialized_memory


def _put_fill(value):
    torch.utils.deterministic.fill_uninitialized_memory = value


_NO_FILL = ProcessSwitch(_get_fill, _put_fill, False)


def unfilled_empty():
    """Under deterministic(), torch fills every tensor it allocates without
    initializing (``torch.empty``, ``resize_``, the outputs of most
    non-elementwise ops) with NaN, so that a read of uninitialized memory
    repeats: one fill launch per allocation, hundreds an SE3 LM iteration.
    Code that writes every element it allocates needs none of them;
    graph/se3_solver.py:optimize_se3 holds this around its solve. Process
    state, like deterministic()."""
    return _NO_FILL.hold()


def segment_sum(vals, ids, n, *, sorted_ids=False):
    """out[v] = sum of vals[k] with ids[k] == v; (E, ...) -> (n, ...).

    ``sorted_ids=True`` says that ``ids`` is non-decreasing; ids >= n are
    then dropped (a dump slot costs nothing). Otherwise every id must lie
    in [0, n), and on the card the sum repeats only when called under
    ``deterministic()``.
    """
    if sorted_ids:
        bounds = torch.arange(n + 1, dtype=ids.dtype, device=ids.device)
        offsets = torch.searchsorted(ids, bounds)
        # unsafe: the offsets are non-decreasing by construction, and the
        # checks of the safe path read them back to the host
        return torch.segment_reduce(vals, "sum", offsets=offsets, axis=0,
                                    unsafe=True)
    out = vals.new_zeros((n,) + tuple(vals.shape[1:]))
    return out.index_put_((ids,), vals, accumulate=True)
