"""The batched SPD-solve kernel's wrapper in the PyTorch port (K1): its plain
version against the JAX Pallas kernel, on SPD, indefinite and singular
systems, the CPU dispatch and the bound, on the CPU.

The kernel (``csrc/solve_psd.cu``) runs only on a CUDA device:
``test_kernel_matches_plain`` is marked ``cuda`` and skips without one
(``python -m pytest --noconftest tests/test_torch_solve_kernel.py -m cuda``
on a GPU host).

Tolerances: on SPD systems A = X Xᵀ + n I (well conditioned; both sides
factor in float32 in the same column order) 1e-5 absolute as
tests/test_pallas.py, 1e-4 on the card at n up to 32. On the non-PD
systems, whose pivots are exact in float32, the non-finite entries must
fall in the same places and the finite ones agree to 1e-5 relative to the
system's largest finite |x|.
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


def _non_pd(K, n, seed=0):
    """Block-diagonal systems whose non-PD pivots are exact in float32, by
    system k % 4: a negative pivot (an indefinite A), a zero pivot in the
    last row (x ends inf, the rows above NaN), a zero pivot in the first
    row (x all NaN), and an indefinite diagonal (2, -1, 3, ...); beside
    the pivot, a dense well-conditioned block on the other rows."""
    rng = np.random.RandomState(seed)
    A = np.zeros((K, n, n), np.float32)
    for k in range(K):
        case = k % 4
        if case == 3:
            A[k] = np.diag(np.resize(np.float32([2, -1, 3]), n))
            continue
        p = n - 1 if case == 1 else 0  # the pivot's row
        rest = np.arange(n)[np.arange(n) != p]
        X = rng.randn(n - 1, n - 1).astype(np.float32)
        A[k][np.ix_(rest, rest)] = X @ X.T + n * np.eye(n - 1, dtype=np.float32)
        A[k, p, p] = -1.0 if case == 0 else 0.0
    return A, rng.randn(K, n).astype(np.float32)


def _nan_upper(A):
    """A with its strict upper triangle set to NaN: a solve reads only the
    lower one."""
    A = A.copy()
    i, j = np.triu_indices(A.shape[-1], 1)
    A[:, i, j] = np.nan
    return A


def _pallas(A, b):
    """``_solve_kernel`` in Pallas interpret mode on the env-last planes
    that ``solve_psd_pallas`` builds, as tests/test_pallas.py runs it. (JAX
    is imported here, not at the top, so that the ``cuda`` tests below also
    run on a GPU host without JAX.)"""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from maniskill_tpu.physics import pallas_kernels as pk

    K, n, _ = A.shape
    At = jnp.asarray(A).transpose(2, 1, 0).reshape(n * n, K)  # row j*n+i = A[:, i, j]
    np.testing.assert_array_equal(np.asarray(At)[2 * n + 1], A[:, 1, 2])
    out = pl.pallas_call(
        functools.partial(pk._solve_kernel, n),
        out_shape=jax.ShapeDtypeStruct((n, K), jnp.float32),
        grid=(1,),
        in_specs=[pl.BlockSpec((n * n, K), lambda i: (0, i)),
                  pl.BlockSpec((n, K), lambda i: (0, i))],
        out_specs=pl.BlockSpec((n, K), lambda i: (0, i)),
        interpret=True,
    )(At, jnp.asarray(b).T)
    return np.asarray(out).T


def _assert_same_non_finite(got, ref, rtol=1e-5):
    """Non-finite entries in the same places; the finite ones within rtol of
    each system's largest finite |ref|."""
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(ref))
    fin = np.isfinite(ref)
    scale = np.where(fin, np.abs(ref), 0).max(axis=-1, keepdims=True)
    err = np.where(fin, np.abs(got - np.where(fin, ref, 0)), 0)
    assert (err <= rtol * scale).all(), (err / np.maximum(scale, 1e-30)).max()


def test_plain_matches_pallas_kernel_interpret():
    """The plain version (``linalg.solve_psd``) against ``_solve_kernel``
    run in Pallas interpret mode, K=256, n=9."""
    K, n = 256, 9
    A, b = _systems(K, n)
    out = _pallas(A, b)
    got = solve_kernel.solve_psd(torch.tensor(A), torch.tensor(b))
    np.testing.assert_allclose(got.numpy(), out, atol=1e-5)
    np.testing.assert_allclose(A @ got.numpy()[..., None], b[..., None], atol=1e-4)


@pytest.mark.parametrize("n", [3, 7])
def test_plain_matches_pallas_kernel_non_pd(n):
    """The TPU kernel's pivot semantics: L_jj = s rsqrt(max(s, 1e-12)), and
    both substitutions divide by it. A negative pivot gives a negative L_jj
    and a finite x (diag(2, -1, 3), b = 1: x_1 = 1e-12); a zero pivot gives
    inf and NaN. The plain version matches the Pallas kernel in interpret
    mode in the places of the non-finite entries and in the finite ones."""
    A, b = _non_pd(8, n, seed=n)
    out = _pallas(A, b)
    got = solve_kernel.solve_psd(torch.tensor(A), torch.tensor(b)).numpy()
    _assert_same_non_finite(got, out)
    np.testing.assert_allclose(got[3::4], out[3::4], rtol=1e-5, atol=0)  # diagonal: each entry
    assert np.isfinite(got[0::4]).all() and np.isfinite(got[3::4]).all()
    assert np.isinf(got[1::4, -1]).all() and np.isnan(got[1::4, :-1]).all()
    assert np.isnan(got[2::4]).all()
    x = linalg.solve_psd(torch.diag(torch.tensor([2.0, -1.0, 3.0]))[None], torch.ones(1, 3))
    torch.testing.assert_close(x[0], torch.tensor([0.5, 1e-12, 1 / 3]), rtol=1e-6, atol=0)


def test_plain_ignores_upper_triangle():
    """Only the lower triangle of A is read: a strict upper triangle of NaN
    gives the same bits, SPD and non-PD alike."""
    for A, b in (_systems(16, 9), _non_pd(8, 9)):
        want = linalg.solve_psd(torch.tensor(A), torch.tensor(b))
        got = linalg.solve_psd(torch.tensor(_nan_upper(A)), torch.tensor(b))
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)


def test_cpu_tensors_take_plain_path():
    """CPU tensors run the plain version and launch nothing; the launch
    itself refuses CPU tensors, a non-contiguous A, n > 32 and bad shapes."""
    A, b = (torch.tensor(x) for x in _systems(5, 4))
    before = solve_kernel.launches
    got = solve_kernel.solve_psd(A, b)
    torch.testing.assert_close(got, linalg.solve_psd(A, b), rtol=0, atol=0)
    assert solve_kernel.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        solve_kernel.launch(A, b)
    with pytest.raises(ValueError, match="contiguous"):
        solve_kernel.launch(A.transpose(1, 2), b)
    A33, b33 = (torch.tensor(x) for x in _systems(2, 33))
    with pytest.raises(ValueError, match="n <= 32"):
        solve_kernel.launch(A33, b33)
    with pytest.raises(ValueError):
        solve_kernel.solve_psd(A[:, :3], b)
    assert solve_kernel.launches == before


def test_work_counts_bytes_and_operations():
    nbytes, ops = solve_kernel.work(4096, 21)
    assert nbytes == 4 * 4096 * (231 + 42)  # lower triangle of A, b and x
    assert ops == pytest.approx(4096 * (21 ** 3 / 3 + 2 * 21 * 21))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["spd", "non_pd"])
@pytest.mark.parametrize("n", [1, 9, 15, 21, 27, 32])
@pytest.mark.parametrize("K", [4096, 37, 1])
def test_kernel_matches_plain(K, n, case):
    """The CUDA kernel against the plain version on the card, with the
    strict upper triangle of A set to NaN for the kernel; K=37 and K=1 run
    the ragged edge. SPD systems within 1e-4; non-PD ones (a negative or
    a zero pivot beside a dense block) with their non-finite entries in the
    plain version's places and the rest within 1e-5 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    A, b = _systems(K, n, seed=n) if case == "spd" else _non_pd(K, n, seed=n)
    A_nan, A, b = (torch.tensor(x, device="cuda") for x in (_nan_upper(A), A, b))
    before = solve_kernel.launches
    got = solve_kernel.solve_psd(A_nan, b)
    ref = linalg.solve_psd(A, b)
    torch.cuda.synchronize()
    assert solve_kernel.launches == before + 1
    if case == "spd":
        assert torch.isfinite(got).all()
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-4)
    else:
        _assert_same_non_finite(got.cpu(), ref.cpu())
        torch.testing.assert_close(got[3::4], ref[3::4], rtol=1e-5, atol=0)  # diagonal
