"""The batched SPD-solve kernel's wrapper in the PyTorch port (K1): its plain
version against the JAX Pallas kernel, the env-last layout, the CPU
dispatch and the bound, on the CPU.

The kernel (``csrc/solve_psd.cu``) runs only on a CUDA device:
``test_kernel_matches_plain`` is marked ``cuda`` and skips without one
(``python -m pytest --noconftest tests/test_torch_solve_kernel.py -m cuda``
on a GPU host).

Tolerance 1e-5 as tests/test_pallas.py: A = X Xᵀ + n I keeps the systems
well conditioned, and both sides factor in float32 in the same column
order; on the card 1e-4 at n up to 21.
"""
import functools

import numpy as np
import pytest
import torch

from maniskill_tpu_torch.physics import linalg, solve_kernel

# one intra-op thread per process: the suite runs several pytest workers on
# the cores, and torch's own thread pool on top of them thrashes small ops
torch.set_num_threads(1)


def _systems(K, n, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(K, n, n).astype(np.float32)
    A = X @ X.transpose(0, 2, 1) + n * np.eye(n, dtype=np.float32)
    return A, rng.randn(K, n).astype(np.float32)


def test_plain_matches_pallas_kernel_interpret():
    """The plain version (``linalg.solve_psd``) against ``_solve_kernel``
    run in Pallas interpret mode, K=256, n=9, as tests/test_pallas.py
    runs it; the port's env-last planes are the ones the TPU wrapper
    builds. (JAX is imported here, not at the top, so that the ``cuda``
    test below also runs on a GPU host without JAX.)"""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from maniskill_tpu.physics import pallas_kernels as pk

    K, n = 256, 9
    A, b = _systems(K, n)
    At_j = jnp.asarray(A).transpose(2, 1, 0).reshape(n * n, K)  # solve_psd_pallas's layout
    At_t, bt_t = solve_kernel.to_planes(torch.tensor(A), torch.tensor(b))
    np.testing.assert_array_equal(At_t.numpy(), np.asarray(At_j))
    np.testing.assert_array_equal(bt_t.numpy(), b.T)
    out = pl.pallas_call(
        functools.partial(pk._solve_kernel, n),
        out_shape=jax.ShapeDtypeStruct((n, K), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((n * n, K), lambda i: (0, i)),
                  pl.BlockSpec((n, K), lambda i: (0, i))],
        out_specs=pl.BlockSpec((n, K), lambda i: (0, i)),
        interpret=True,
    )(At_j, jnp.asarray(b).T).T
    got = solve_kernel.solve_psd(torch.tensor(A), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=1e-5)
    np.testing.assert_allclose(A @ got.numpy()[..., None], b[..., None], atol=1e-4)


def test_cpu_tensors_take_plain_path():
    """CPU tensors run the plain version and launch nothing; the launch
    itself refuses CPU tensors and bad shapes."""
    A, b = _systems(5, 4)
    before = solve_kernel.launches
    got = solve_kernel.solve_psd(torch.tensor(A), torch.tensor(b))
    torch.testing.assert_close(got, linalg.solve_psd(torch.tensor(A), torch.tensor(b)),
                               rtol=0, atol=0)
    assert solve_kernel.launches == before
    with pytest.raises(ValueError):
        solve_kernel.launch(*solve_kernel.to_planes(torch.tensor(A), torch.tensor(b)))
    with pytest.raises(ValueError):
        solve_kernel.solve_psd(torch.tensor(A)[:, :3], torch.tensor(b))


def test_work_counts_bytes_and_operations():
    nbytes, ops = solve_kernel.work(4096, 21)
    assert nbytes == 4 * 4096 * (231 + 42)  # lower triangle of A, b and x
    assert ops == pytest.approx(4096 * (21 ** 3 / 3 + 2 * 21 * 21))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [9, 15, 21])
@pytest.mark.parametrize("K", [4096, 37])
def test_kernel_matches_plain(K, n):
    """The CUDA kernel against the plain version on the card; K=37 runs
    the masked ragged edge."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A, b = (torch.tensor(x, device="cuda") for x in _systems(K, n, seed=n))
    before = solve_kernel.launches
    got = solve_kernel.solve_psd(A, b)
    ref = linalg.solve_psd(A, b)
    torch.cuda.synchronize()
    assert solve_kernel.launches == before + 1
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
