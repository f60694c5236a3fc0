"""The versioned-slot op's wrapper (``repro_torch.kernels.slot_bump``) on the
CPU: its plain path against the JAX package's op
(``repro.sync.workloads.versioned_slot_op`` over [B, N] rows and
``versioned_slot_cell_op`` over [N]), and the edge cases the CUDA kernel
must keep (counts of 0, below 0 and at or past the row width; negative
versions; the int32 wrap of ``x + 1``). The kernel itself is held to the
plain version on the card in ``tests/test_torch_cuda.py``, which draws its
inputs with :func:`slot_rows` and so imports this file: JAX is imported
only inside :func:`jax_slot_bumps`."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import slot_bump as ksb

I32_MAX = np.iinfo(np.int32).max


def slot_rows(rng, lead, u):
    """``x`` [*lead, u] int32 with negative entries, INT32_MAX and all-zero
    rows, and counts [*lead], half 0, the rest among -7, -1, 1, u - 1, u,
    u + 5 (numpy; the card tests draw theirs here too)."""
    x = rng.integers(-60, 200, size=(*lead, u)).astype(np.int32)
    flat = x.reshape(-1, u)
    rows = flat.shape[0]
    flat[rng.random(rows) < 0.2] = 0
    flat[rng.random(flat.shape) < 0.05] = I32_MAX
    choices = np.array([-7, -1, 1, max(u - 1, 1), u, u + 5], np.int32)
    cnt = np.where(rng.random(rows) < 0.5, 0, rng.choice(choices, size=rows))
    return x, cnt.astype(np.int32).reshape(lead)


def draw(seed, lead, u):
    x, cnt = slot_rows(np.random.default_rng(seed), lead, u)
    return torch.from_numpy(x), torch.from_numpy(cnt)


def jax_slot_bumps(x, cnt, u):
    """The JAX package's op on ``x`` [B, N, u] or [N, u] with ``cnt`` [B, N]
    or [N], through a one-round count table [1, N, B]."""
    import jax.numpy as jnp

    from repro.sync import workloads as jW

    xs, c = jnp.asarray(x.numpy()), cnt.numpy()
    if x.dim() == 3:
        out = jW.versioned_slot_op(c.T[None], u)(xs, 0)
    else:
        out = jW.versioned_slot_cell_op(c[None, :, None], 0, u)(xs, 0)
    return torch.from_numpy(np.array(out))


@pytest.mark.parametrize("lead", [(7, 5), (33,)], ids=["BN", "N"])
@pytest.mark.parametrize("u", [1, 3, 8, 64, 100])
def test_plain_path_equals_jax(u, lead):
    x, cnt = draw(u * 10 + len(lead), lead, u)
    got = ksb.slot_bump(x, cnt, u)
    assert got.dtype == torch.int32 and got.shape == x.shape
    want = jax_slot_bumps(x, cnt, u)
    assert want.dtype == torch.int32
    assert torch.equal(got, want)


def test_rows_without_a_positive_count_are_exact_zeros():
    x, cnt = draw(3, (40, 6), 16)
    got = ksb.slot_bump(x, cnt, 16)
    idle = cnt <= 0
    assert bool(idle.any()) and bool((~idle).any())
    assert not bool(got[idle].any())
    assert bool(got[~idle].any())


def test_negative_versions_and_the_int32_wrap():
    """A row's version mod U is the floor remainder (a negative version
    starts at a non-negative slot), and INT32_MAX + 1 wraps to INT32_MIN."""
    x = torch.tensor([[-5, -3, -7, -1], [I32_MAX, 0, 0, 0]],
                     dtype=torch.int32)
    cnt = torch.tensor([2, 2], dtype=torch.int32)
    # version -1 → slot 3, then 0; version INT32_MAX → slot 3, then 0
    want = torch.tensor([[-4, 0, 0, 0], [-2**31, 0, 0, 1]],
                        dtype=torch.int32)
    assert torch.equal(ksb.slot_bump(x, cnt, 4), want)
    assert torch.equal(jax_slot_bumps(x, cnt, 4), want)


@pytest.mark.parametrize("extra", [0, 1, 1000])
def test_a_count_of_the_width_or_more_bumps_every_slot(extra):
    x = torch.arange(24, dtype=torch.int32).reshape(2, 3, 4) - 5
    cnt = torch.full((2, 3), 4 + extra, dtype=torch.int32)
    assert torch.equal(ksb.slot_bump(x, cnt, 4), x + 1)


@pytest.mark.parametrize("x_shape,cnt_shape", [
    ((4, 3, 8), (3,)), ((4, 3, 8), (4, 4)), ((4, 3, 8), (4, 3, 8)),
    ((), ())])
def test_wrapper_refuses_mismatched_shapes(x_shape, cnt_shape):
    x = torch.zeros(x_shape, dtype=torch.int32)
    cnt = torch.ones(cnt_shape, dtype=torch.int32)
    with pytest.raises(ValueError):
        ksb.slot_bump(x, cnt, x_shape[-1] if x_shape else 1)
