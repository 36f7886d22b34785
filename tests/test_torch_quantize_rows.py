"""``quantize_rows`` (``csrc/quantize_rows.cu``) on the CPU: the launch plan
and the partition of each row over the kernel's blocks, threads and
16-byte loads at every timed shape (each element read once, held in
registers), and the plain version against the reference's Pallas kernel
(interpret mode) at a capacity buffer's shape with its zero rows.  The
kernel itself runs only on the card (``tests/test_torch_gpu.py``)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quantize import quantize_rows as jquantize_rows
from repro_torch.kernels.quantize import ROWS_MAX_BLOCKS, ROWS_MAX_LOADS, ROWS_THREADS, quantize_rows, rows_plan

SMS = 132


def rows_partition(d, itemsize, plan):
    """The 16-byte vector of a row that each (block of the row's cluster,
    load, thread) of the kernel reads: int64 (cs, nv, ROWS_THREADS), -1
    where the load is masked off.  Block r takes vectors [r per, (r + 1)
    per), its thread i load j vector r per + i + ROWS_THREADS j; block b of
    the grid (cs x M blocks) is row b // cs, rank b % cs."""
    vecs, cs, nv = d * itemsize // 16, plan["cs"], plan["nv"]
    per = -(-vecs // cs)
    r = torch.arange(cs)[:, None, None]
    v = r * per + torch.arange(ROWS_THREADS)[None, None] + ROWS_THREADS * torch.arange(nv)[None, :, None]
    return torch.where(v < torch.clamp((r + 1) * per, max=vecs), v, -1)


TIMED = [  # (rows, D, bytes an element): the decode tick, a prefill chunk, the MoE capacity buffers at C 8
    (4, 4096, 2), (256, 12288, 2), (64, 6144, 2), (64, 32768, 4), (1024, 7168, 2), (1024, 4864, 4),
]


@pytest.mark.parametrize("m,d,itemsize", TIMED + [(8, 49152, 4), (3, 64, 4), (5, 12288, 2)])
def test_partition_reads_each_element_once(m, d, itemsize):
    """Every 16-byte vector of a row is one (block, load, thread)'s, and the
    cs x M blocks of the grid are the rows' clusters; a thread's loads fit
    its registers (at most ROWS_MAX_LOADS) and a cluster is portable."""
    plan = rows_plan(m, d, itemsize, SMS)
    assert 1 <= plan["cs"] <= ROWS_MAX_BLOCKS and 1 <= plan["nv"] <= ROWS_MAX_LOADS
    part = rows_partition(d, itemsize, plan)
    got = part[part >= 0]
    assert got.numel() == d * itemsize // 16
    assert torch.equal(torch.sort(got).values, torch.arange(d * itemsize // 16))
    blocks = torch.arange(plan["cs"] * m)
    assert torch.equal(torch.unique(blocks // plan["cs"]), torch.arange(m))


def test_plan_spreads_few_long_rows_and_keeps_short_ones_whole():
    """One block a row where its registers hold it; a capacity buffer's
    (64, 32768) f32 rows over 4 blocks (128 KB a row); rows past 8 blocks
    of registers take the two-pass kernel (nv 0)."""
    assert rows_plan(4, 4096, 2, SMS) == dict(cs=1, nv=2)
    assert rows_plan(256, 12288, 2, SMS) == dict(cs=1, nv=6)
    assert rows_plan(64, 32768, 4, SMS) == dict(cs=4, nv=8)
    assert rows_plan(1024, 4864, 4, SMS)["cs"] == 1
    cap = ROWS_MAX_BLOCKS * ROWS_THREADS * ROWS_MAX_LOADS * 16  # bytes of the longest register-held row
    assert rows_plan(2, cap // 4, 4, SMS)["nv"] > 0
    assert rows_plan(2, cap // 4 + 4, 4, SMS) == dict(cs=1, nv=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_reference_at_a_capacity_buffer(dtype):
    """grok-1's decode capacity buffer, (E * C, d) = (64, 6144): the routed
    rows random, the other rows zero (half the buffer), a NaN, a row of
    max exactly 127 * 2**-3, a subnormal max: the port's quantize_rows (on
    the CPU: its plain version) gives the reference kernel's mantissas and
    exponents."""
    rng = np.random.default_rng(64)
    x = (rng.normal(size=(64, 6144)) * 0.1).astype(np.float32)
    x[rng.permutation(64)[:32]] = 0.0
    x[0, 3], x[1, 5], x[2] = np.nan, 127.0 * 2.0**-3, 0.0
    x[2, 7] = 1e-39
    jx = jnp.asarray(x).astype(jnp.bfloat16) if dtype == "bfloat16" else jnp.asarray(x)
    wq, we = jquantize_rows(jx, interpret=True)
    q, e = quantize_rows(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert np.array_equal(q.numpy(), np.asarray(wq))
    assert np.array_equal(e.numpy(), np.asarray(we))
