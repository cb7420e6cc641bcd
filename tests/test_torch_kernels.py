"""The 1-NN kernel wrapper and, on a card, the kernel against its plain
version. Imports torch and the port only, so that the card's machine runs
it without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import re

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu_torch.ops import knn as P_knn
from delta_graph_slam_tpu_torch.ops import nn_kernel

CASES = ["tiles", "ragged", "all_invalid_targets", "exclude_self",
         "single_query", "ties"]


def np_(x):
    return x.cpu().numpy()


def nn_case(name):
    """(query, qmask, target, tmask) float32/bool inputs of one case."""
    rng = np.random.default_rng(0)
    if name == "ties":         # equal minima in other slices and tiles
        return nn_kernel.tie_case(rng)
    if name == "tiles":        # the shapes of test_ops_cloud.py:275-298
        n, m = 512, 1024
        qm = np.arange(n) < 500
        tm = np.arange(m) < 1000
    elif name == "single_query":
        n, m = 1, 4097
        qm = np.ones(n, bool)
        tm = rng.random(m) > 0.2
    else:                      # ragged, with holes in both masks
        n, m = 1000, 3001
        qm = rng.random(n) > 0.1
        tm = rng.random(m) > 0.2
    if name == "all_invalid_targets":
        tm = np.zeros(m, bool)
    q = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    t = rng.uniform(-5, 5, (m, 3)).astype(np.float32)
    if name == "exclude_self":
        t = q.copy()
        tm = qm.copy()
    return q, qm, t, tm


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def test_nn_1_cuda_wrapper_rejects_cpu_tensors():
    """On a CPU tensor the kernel wrapper raises instead of running anything
    (nn_1 picks the plain version by the device, before the wrapper)."""
    q = torch.zeros((4, 3))
    m = torch.ones(4, dtype=torch.bool)
    before = nn_kernel.launches
    with pytest.raises(ValueError, match="must be on"):
        nn_kernel.nn_1_cuda(q, m, q, m)
    assert nn_kernel.launches == before


@pytest.mark.parametrize("case", CASES)
def test_nn_1_dispatches_cpu_tensors_to_the_plain_version(case):
    q, qm, t, tm = (torch.from_numpy(x) for x in nn_case(case))
    excl = case == "exclude_self"
    before = nn_kernel.launches
    got = P_knn.nn_1(q, qm, t, tm, exclude_self=excl, chunk=700)
    want = P_knn.nn_1_reference(q, qm, t, tm, exclude_self=excl, chunk=700)
    assert nn_kernel.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    """No compiler, no kernel: the build raises instead of falling back."""
    import shutil

    import torch.utils.cpp_extension as ext

    monkeypatch.setattr(shutil, "which", lambda name: None)
    monkeypatch.setattr(ext, "CUDA_HOME", None)
    monkeypatch.setattr(nn_kernel, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc"):
        nn_kernel.build()
    assert nn_kernel.library_path().name.startswith("libdgs_nn1_")


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_nn_1_kernel_matches_plain_on_card(cuda_device, case):
    q, qm, t, tm = nn_case(case)
    excl = case == "exclude_self"
    args = [torch.from_numpy(x).to(cuda_device) for x in (q, qm, t, tm)]
    before = nn_kernel.launches
    d2_k, i_k = nn_kernel.nn_1_cuda(*args, exclude_self=excl)
    torch.cuda.synchronize()
    assert nn_kernel.launches == before + 1
    d2_r, i_r = P_knn.nn_1_reference(*args, exclude_self=excl)
    d2_k, i_k, d2_r, i_r = map(np_, (d2_k, i_k, d2_r, i_r))
    np.testing.assert_array_equal(np.isinf(d2_k), np.isinf(d2_r))
    fin = np.isfinite(d2_r)
    # d2 atol 1e-3 and > 99% index agreement, as against the JAX package
    np.testing.assert_allclose(d2_k[fin], d2_r[fin], atol=1e-3)
    if fin.any():
        assert (i_k[fin] == i_r[fin]).mean() > 0.99
    if case == "ties":  # exact distances: the first of the equal copies
        np.testing.assert_array_equal(i_k, i_r)
        assert (i_k < len(t) // 4).all()


@pytest.mark.cuda
def test_nn_1_kernel_is_repeatable_on_card(cuda_device):
    """The fitness shape (28000 x 27500 valid of 32768 x 32768), three
    launches: the partials merge in a fixed order, so the bits never move."""
    rng = np.random.default_rng(1)
    n = 32768
    q = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    t = rng.uniform(-25, 25, (n, 3)).astype(np.float32)
    args = [torch.from_numpy(x).to(cuda_device)
            for x in (q, np.arange(n) < 28000, t, np.arange(n) < 27500)]
    runs = [nn_kernel.nn_1_cuda(*args) for _ in range(3)]
    torch.cuda.synchronize()
    for d2, idx in runs[1:]:
        assert torch.equal(d2, runs[0][0]) and torch.equal(idx, runs[0][1])


GEOMETRY_N = [1, 511, 512, 1000, 28000, 32768, 200000]


@pytest.mark.parametrize("n", GEOMETRY_N)
def test_launch_geometry_covers_the_targets_once(n):
    """For every (M, SM count): 1 <= splits <= 8, and the round-robin
    assignment of target tiles to splits (split s takes tiles s, s + splits,
    ...) covers every tile exactly once with no split left empty; the query
    tiles cover N."""
    for m in (0, 1, 511, 513, 3001, 27500, 32768, 100000):
        for sms in (1, 16, 78, 114, 132):
            splits, q_tiles = nn_kernel.launch_geometry(n, m, sms)
            assert 1 <= splits <= nn_kernel.MAX_SPLITS, (n, m, sms, splits)
            tiles = -(-m // nn_kernel.TILE)
            owned = [list(range(s, tiles, splits)) for s in range(splits)]
            assert sorted(t for ts in owned for t in ts) == list(range(tiles))
            assert m == 0 or all(owned), (n, m, sms, splits)
            assert (q_tiles - 1) * nn_kernel.QUERIES_PER_BLOCK < n
            assert q_tiles * nn_kernel.QUERIES_PER_BLOCK >= n


def test_launch_geometry_fills_the_card_at_the_fitness_shape():
    """32768 x 32768 on 132 SMs: four splits, 256 blocks, ~1.9 an SM; a
    small query set takes all eight."""
    assert nn_kernel.launch_geometry(32768, 32768, 132) == (4, 64)
    assert nn_kernel.launch_geometry(1000, 32768, 132) == (8, 2)
    assert nn_kernel.launch_geometry(1, 1, 132) == (1, 1)
    with pytest.raises(ValueError):
        nn_kernel.launch_geometry(0, 10, 132)


def test_launch_geometry_mirrors_the_kernel_constants():
    src = nn_kernel.SOURCE.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("kThreads") * const("kR") == nn_kernel.QUERIES_PER_BLOCK
    assert const("kTile") == nn_kernel.TILE
    assert const("kMaxSplits") == nn_kernel.MAX_SPLITS
