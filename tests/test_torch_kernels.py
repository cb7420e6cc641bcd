"""The 1-NN kernel wrapper and, on a card, the kernel against its plain
version. Imports torch and the port only, so that the card's machine runs
it without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu_torch.ops import knn as P_knn
from delta_graph_slam_tpu_torch.ops import nn_kernel

CASES = ["tiles", "ragged", "all_invalid_targets", "exclude_self"]


def np_(x):
    return x.cpu().numpy()


def nn_case(name):
    """(query, qmask, target, tmask) float32/bool inputs of one case."""
    rng = np.random.default_rng(0)
    if name == "tiles":        # the shapes of test_ops_cloud.py:275-298
        n, m = 512, 1024
        qm = np.arange(n) < 500
        tm = np.arange(m) < 1000
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


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
