"""Fused unembed + sampling of the port against the JAX package's Pallas
kernel (interpret mode): token-exact, on all the reference's cases.

The port takes the head as (V, D) row-major; the reference's unembed is
(D, V), so the tests hand the port its transpose.  On the CPU the wrapper
takes the kernel's plain version; ``test_torch_cuda.py`` holds the CUDA
kernel to it on the card.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.sampling.kernel import unembed_sample_pallas
from repro.kernels.sampling.ref import unembed_sample_ref as j_ref
from repro_torch.kernels.sampling import ops as sops
from repro_torch.kernels.sampling.ops import fused_unembed_sample
from repro_torch.kernels.sampling.ref import (unembed_sample_ref,
                                              unembed_scores)

CASES = [
    # (B, D, V, block_v) of the reference's tests: ragged last tiles
    (1, 32, 257, 128),
    (4, 64, 1000, 256),
    (3, 48, 512, 512),
    (2, 64, 769, 128),
    (5, 32, 130, 64),
]


def _setup(case, seed=0):
    b, d, v, _ = case
    rng = np.random.default_rng(seed)
    last = rng.standard_normal((b, d)).astype(np.float32)
    unembed = (rng.standard_normal((d, v)) * 0.3).astype(np.float32)
    return last, unembed


def _pallas(last, unembed, block_v, seed=0, temperature=0.0):
    return np.asarray(unembed_sample_pallas(
        jnp.asarray(last), jnp.asarray(unembed),
        jnp.asarray([seed], jnp.int32), temperature=temperature,
        block_v=block_v, interpret=True))


def _port(last, unembed, seed=0, temperature=0.0):
    head = torch.from_numpy(np.ascontiguousarray(unembed.T))
    return fused_unembed_sample(torch.from_numpy(last), head, seed,
                                temperature=temperature).numpy()


@pytest.mark.parametrize('case', CASES)
def test_greedy_matches_pallas_and_argmax(case):
    last, unembed = _setup(case, seed=sum(case))
    got = _port(last, unembed)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, _pallas(last, unembed, case[3]))
    np.testing.assert_array_equal(got, np.asarray(j_ref(
        jnp.asarray(last), jnp.asarray(unembed))))


@pytest.mark.parametrize('case', CASES[:3])
@pytest.mark.parametrize('seed', [0, 17])
def test_temperature_matches_pallas(case, seed):
    """The same counter-hash Gumbel noise in both: exact at T > 0 too."""
    last, unembed = _setup(case, seed=3)
    got = _port(last, unembed, seed, temperature=0.8)
    np.testing.assert_array_equal(
        got, _pallas(last, unembed, case[3], seed, temperature=0.8))


def test_temperature_seed_actually_samples():
    last, unembed = _setup((8, 32, 257, 128), seed=5)
    draws = [_port(last, unembed, s, temperature=2.0) for s in range(12)]
    assert any(not np.array_equal(draws[0], d) for d in draws[1:])
    np.testing.assert_array_equal(draws[0],
                                  _port(last, unembed, 0, temperature=2.0))


def test_tie_break_is_first_occurrence_across_tiles():
    b, d, v, block_v = 2, 16, 300, 128
    last = np.ones((b, d), np.float32)
    w = np.zeros((d, v), np.float32)
    w[:, 40] = w[:, 200] = w[:, 299] = 1.0
    got = _port(last, w)
    np.testing.assert_array_equal(got, _pallas(last, w, block_v))
    assert got.tolist() == [40, 40]


def test_padding_vocab_never_wins():
    b, d, v = 2, 16, 130
    rng = np.random.default_rng(11)
    last = rng.standard_normal((b, d)).astype(np.float32)
    unembed = (-np.abs(rng.standard_normal((d, v))) - 5.0).astype(np.float32)
    got = _port(last, unembed)
    assert (got < v).all()
    np.testing.assert_array_equal(got, _pallas(last, unembed, 64))


def test_head_must_be_row_major_v_by_d():
    """A transposed view of the embedding table is refused: it would make
    the kernel read the head column-wise (or copy 311 MB per step)."""
    last, unembed = _setup(CASES[1])
    head = torch.from_numpy(unembed)             # (D, V) contiguous
    with pytest.raises(ValueError, match='row-major'):
        fused_unembed_sample(torch.from_numpy(last), head.T)
    with pytest.raises(ValueError, match=r'\(V, D\)'):
        fused_unembed_sample(torch.from_numpy(last), head)


def test_scores_are_f32_from_the_operands():
    """The port's one rounding choice: f32 scores of the model-dtype
    operands, for the fused kernel, its plain version and the unfused
    tail alike."""
    rng = np.random.default_rng(2)
    last = torch.tensor(rng.standard_normal((3, 64)), dtype=torch.bfloat16)
    head = torch.tensor(rng.standard_normal((500, 64)), dtype=torch.bfloat16)
    s = unembed_scores(last, head)
    assert s.dtype == torch.float32
    torch.testing.assert_close(s, last.float() @ head.float().T)
    np.testing.assert_array_equal(unembed_sample_ref(last, head).numpy(),
                                  s.argmax(-1).numpy())


@pytest.mark.parametrize('sms', [114, 132])      # H100 PCIe, H100 SXM
@pytest.mark.parametrize('vocab', [1, 63, 64, 65, 257, 8448, 8449, 92544,
                                   151936])
def test_plan_vocab_ranges_covers_every_row_once(vocab, sms):
    """The CUDA kernel's persistent CTAs: whole 64-row tiles each, at most
    one CTA a multiprocessor, none empty, every vocab row in exactly one
    range, in order."""
    rows = sops.plan_vocab_ranges(vocab, sms)
    n_ctas = -(-vocab // rows)
    assert rows % sops.TILE_ROWS == 0 and n_ctas <= sms
    ranges = [range(c * rows, min((c + 1) * rows, vocab))
              for c in range(n_ctas)]
    assert all(len(r) > 0 for r in ranges)
    assert [v for r in ranges for v in r] == list(range(vocab))


@pytest.mark.parametrize('arch', ['qwen3-0.6b', 'internlm2-1.8b',
                                  'qwen3-14b', 'llama4-scout-17b-a16e',
                                  'command-r-35b'])
def test_every_served_head_fits_the_kernel_s_shared_memory(arch):
    """The kernel keeps ``last`` whole in shared memory beside at least two
    head boxes: 16 rows a launch up to D = 6656 (qwen3-14b's and
    llama4-scout's 5120), 8 rows a launch past it (command-r's 8192), so
    every served head is taken at any batch; the rows a launch and the
    largest width are sampling.cu's arithmetic."""
    from repro_torch.configs import get_config

    d = get_config(arch).d_model
    step = sops.launch_rows(d)
    assert d <= sops.max_head_dim(step) and d % 8 == 0
    assert step == (16 if d <= 6656 else 8)
    for rows, widest in ((16, 6656), (8, 13312)):
        assert sops.max_head_dim(rows) == widest
        n = 8 if rows <= 8 else 16
        slices = widest // 64
        smem = 1024 + slices * n * 128 + 8 + 2 * (64 * 128 + 16)
        assert smem <= sops.SMEM_BUDGET < smem + n * 128


def _blocks(v, n):
    """n column blocks of a vocabulary of v: equal where n divides v, else
    the last one shorter."""
    step = -(-v // n)
    return [(lo, min(lo + step, v)) for lo in range(0, v, step)]


@pytest.mark.parametrize('n', [2, 3, 4])
@pytest.mark.parametrize('temperature,seed', [(0.0, 0), (0.7, 3), (1.3, 11)])
@pytest.mark.parametrize('rows', [(0, 5), (2, 5), (3, 4)],
                         ids=['all', 'row0=2', 'row0=3'])
def test_block_sampler_and_combine_equal_the_whole_head(n, temperature,
                                                        seed, rows):
    """``unembed_argmax_block`` over n blocks of the head, on rows
    row0..hi of the batch, combined (larger value, ties to the lower
    column) equals the reference's sampler over the whole head on the
    whole batch at those rows: the noise is drawn at the global (row,
    column)."""
    from repro_torch.kernels.sampling.ops import unembed_argmax_block
    from repro_torch.kernels.sampling.ref import combine_bests

    b, d, v = 5, 48, 1000
    last, unembed = _setup((b, d, v, 0), seed=7)
    want = np.asarray(j_ref(jnp.asarray(last), jnp.asarray(unembed),
                            seed=seed, temperature=temperature))
    lo, hi = rows
    head = torch.from_numpy(np.ascontiguousarray(unembed.T))
    x = torch.from_numpy(last[lo:hi])
    parts = [unembed_argmax_block(x, head[c0:c1].contiguous(), seed,
                                  temperature=temperature, row0=lo, col0=c0)
             for c0, c1 in _blocks(v, n)]
    for (val, idx), (c0, c1) in zip(parts, _blocks(v, n)):
        assert val.dtype == torch.float32 and idx.dtype == torch.int32
        assert ((idx >= c0) & (idx < c1)).all()
    got = combine_bests(torch.stack([p[0] for p in parts]),
                        torch.stack([p[1] for p in parts]))
    np.testing.assert_array_equal(got.numpy(), want[lo:hi])
    whole = unembed_argmax_block(x, head, seed, temperature=temperature,
                                 row0=lo)
    assert torch.equal(whole[1], got)


def test_block_tie_across_blocks_goes_to_the_lower_column():
    """Equal best scores in two blocks (and twice inside one): the combine
    returns the first occurrence over the whole head, as the reference."""
    from repro_torch.kernels.sampling.ops import unembed_argmax_block
    from repro_torch.kernels.sampling.ref import combine_bests

    d, v = 16, 64
    last = np.zeros((3, d), np.float32)
    last[:, 0] = 1.0
    unembed = np.zeros((d, v), np.float32)
    unembed[0, [20, 40, 45]] = 2.0          # row r: ties at 20 | 40, 45
    unembed[0, 31] = 1.0
    want = np.asarray(j_ref(jnp.asarray(last), jnp.asarray(unembed)))
    assert (want == 20).all()
    head = torch.from_numpy(np.ascontiguousarray(unembed.T))
    for cut in (32, 21, 41):               # blocks [0, cut), [cut, v)
        parts = [unembed_argmax_block(torch.from_numpy(last),
                                      head[a:b].contiguous(), col0=a)
                 for a, b in ((0, cut), (cut, v))]
        got = combine_bests(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts]))
        np.testing.assert_array_equal(got.numpy(), want)


def test_noise_at_local_columns_is_rejected():
    """The mutant that draws each block's noise at its local columns (and
    reports global ones) samples other tokens than the whole head: the
    block sampler must draw at the global column."""
    from repro_torch.kernels.sampling.ref import (combine_bests,
                                                  unembed_argmax_block_ref)

    b, d, v, n = 16, 32, 1024, 4
    last, unembed = _setup((b, d, v, 0), seed=9)
    want = np.asarray(j_ref(jnp.asarray(last), jnp.asarray(unembed), seed=5,
                            temperature=1.0))
    x = torch.from_numpy(last)
    head = torch.from_numpy(np.ascontiguousarray(unembed.T))
    for local in (False, True):
        parts = []
        for c0, c1 in _blocks(v, n):
            val, idx = unembed_argmax_block_ref(
                x, head[c0:c1], 5, temperature=1.0,
                col0=0 if local else c0)
            parts.append((val, idx + c0 if local else idx))
        got = combine_bests(torch.stack([p[0] for p in parts]),
                            torch.stack([p[1] for p in parts])).numpy()
        assert (got == want).all() != local, local
