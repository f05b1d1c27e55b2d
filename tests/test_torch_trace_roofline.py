"""The trace counter (``repro_torch.roofline.trace_analysis``): the torch
counterparts of ``test_hlo_roofline.py`` and ``test_hlo_property.py``. A
loop of matmuls stands for a scan; each program's dot FLOPs must equal both
the exact formula and the reference's ``analyze_hlo_text`` on the
same-shaped JAX program. Then the per-device count on a fake 2×2 mesh, the
kernels' reports, and the repeated-block extension against a full trace."""

import dataclasses

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.roofline.hlo_analysis import analyze_hlo_text
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.kernels import _costs
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.roofline import HW, TraceCounter, roofline_terms


def trace_cost(fn, *args):
    with TraceCounter() as counter:
        out = fn(*args)
    return out, counter.cost


def _hlo_flops(fn, *shapes):
    args = [jax.ShapeDtypeStruct(s, jnp.float32) for s in shapes]
    return analyze_hlo_text(jax.jit(fn).lower(*args).compile().as_text()).dot_flops


def _torch_flops(fn, *shapes):
    with FakeTensorMode():
        args = [torch.empty(s) for s in shapes]
        return trace_cost(fn, *args)[1]


def _jax_scan(x, ws):
    def body(c, w):
        return c @ w, ()

    return jax.lax.scan(body, x, ws)[0]


def _torch_scan(x, ws):
    for w in ws:
        x = x @ w
    return x


def _jax_nested(inner):
    def f(x, ws):
        def outer(c, w):
            def body(ci, _):
                return ci @ w, ()

            return jax.lax.scan(body, c, None, length=inner)[0], ()

        return jax.lax.scan(outer, x, ws)[0]

    return f


def _torch_nested(inner):
    def f(x, ws):
        for w in ws:
            for _ in range(inner):
                x = x @ w
        return x

    return f


@pytest.mark.parametrize("trips,m", [(7, 256), (1, 64), (5, 128), (12, 64), (3, 256)])
def test_scan_matmul_flops_exact(trips, m):
    want = trips * 2 * m**3
    assert _torch_flops(_torch_scan, (m, m), (trips, m, m)).dot_flops == want
    assert _hlo_flops(_jax_scan, (m, m), (trips, m, m)) == want


@pytest.mark.parametrize("outer,inner,m", [(5, 3, 128), (1, 1, 64), (2, 5, 64), (4, 2, 64)])
def test_nested_scan_flops_exact(outer, inner, m):
    want = outer * inner * 2 * m**3
    assert _torch_flops(_torch_nested(inner), (m, m), (outer, m, m)).dot_flops == want
    assert _hlo_flops(_jax_nested(inner), (m, m), (outer, m, m)) == want


def test_unscanned_matmul_flops():
    want = 2 * 64 * 32 * 48
    assert _torch_flops(lambda a, b: a @ b, (64, 32), (32, 48)).dot_flops == want
    assert _hlo_flops(lambda a, b: a @ b, (64, 32), (32, 48)) == want


def test_mixed_scan_plus_outside_matmul():
    m = 128
    want = 3 * 2 * m**3 + 2 * m * m * 2 * m
    got = _torch_flops(lambda x, ws, a: _torch_scan(x, ws) @ a, (m, m), (3, m, m), (m, 2 * m))
    assert got.dot_flops == want
    assert _hlo_flops(lambda x, ws, a: _jax_scan(x, ws) @ a, (m, m), (3, m, m), (m, 2 * m)) == want


def test_batched_dot_flops():
    want = 4 * 2 * 32 * 48 * 16
    shapes = ((4, 32, 48), (4, 48, 16))
    got = _torch_flops(lambda a, b: torch.einsum("bij,bjk->bik", a, b), *shapes)
    assert got.dot_flops == want and got.dot_count == 1
    assert _hlo_flops(lambda a, b: jnp.einsum("bij,bjk->bik", a, b), *shapes) == want


def test_linear_and_addmm_count_as_dots():
    got = _torch_flops(lambda x, w, b: torch.nn.functional.linear(x, w, b), (8, 16), (32, 16), (32,))
    assert got.dot_flops == 2 * 8 * 16 * 32


def test_traffic_positive_and_bounded():
    """The traffic is at least the unavoidable IO (inputs and output once
    each) and at most 4× it."""
    m = 256
    cost = _torch_flops(lambda a, b: a @ b, (m, m), (m, m))
    unavoidable = 3 * m * m * 4
    assert unavoidable <= cost.traffic_bytes <= 4 * unavoidable


def test_views_and_allocations_move_nothing():
    cost = _torch_flops(lambda a: a.view(16, 16).t()[:10].unsqueeze(0).expand(3, 10, 16), (256,))
    assert cost.traffic_bytes == 0 and cost.dot_flops == 0


def test_an_index_write_counts_its_source_not_its_buffer():
    def write(buf, src, idx):
        buf.index_copy_(1, idx, src)
        return buf

    with FakeTensorMode():
        buf, src = torch.empty(4, 1000, 8), torch.empty(4, 1, 8)
        idx = torch.zeros(1, dtype=torch.long)
        cost = trace_cost(write, buf, src, idx)[1]
    assert cost.traffic_bytes == 2 * src.numel() * 4 + 8


def test_a_gather_reads_its_rows_not_its_table():
    with FakeTensorMode():
        table, idx = torch.empty(50000, 64), torch.zeros(4, 3, dtype=torch.long)
        cost = trace_cost(torch.nn.functional.embedding, idx, table)[1]
    assert cost.traffic_bytes == 2 * 4 * 3 * 64 * 4 + idx.numel() * 8


def test_per_device_count_on_a_fake_mesh():
    """A sharded matmul counts rank 0's share, 2·M·K·N / 4 on 2×2, and the
    redistribution's one all-gather by kind and bytes; DTensor's
    global-shape propagation op is not counted."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    m, k, n = 256, 4096, 8192
    with fake_world(4):
        mesh = make_debug_mesh((2, 2))
        with FakeTensorMode():
            a = distribute_tensor(torch.empty(m, k), mesh, [Shard(0), Shard(1)])
            b = distribute_tensor(torch.empty(k, n), mesh, [Replicate(), Shard(1)])
            with TraceCounter() as counter:
                a @ b
    cost = counter.cost
    assert cost.dot_flops == 2 * m * k * n / 4 and cost.dot_count == 1
    assert cost.collective_counts == {
        "all-gather": 1, "all-reduce": 0, "reduce-scatter": 0, "all-to-all": 0,
        "collective-permute": 0,
    }
    assert cost.collective_bytes["all-gather"] == (m // 2) * k * 4
    assert cost.total_collective_bytes == (m // 2) * k * 4
    assert set(cost.as_dict()) >= {
        "dot_flops", "traffic_bytes", "collective_bytes", "collective_counts",
        "total_collective_bytes", "dot_count", "while_trip_counts",
    }


def test_kernels_report_to_the_innermost_counter():
    assert _costs.COUNTERS == []
    _costs.report("rmsnorm", 0, 100)  # no counter: nothing happens
    with TraceCounter() as outer:
        with TraceCounter() as inner:
            _costs.report("decode_attention", 4096, 1000)
            _costs.report("decode_attention", 4096, 1000)
        _costs.report("rmsnorm", 0, 100)
    assert inner.cost.kernel_calls == {"decode_attention": 2}
    assert inner.cost.dot_flops == 8192 and inner.cost.traffic_bytes == 2000
    assert outer.cost.kernel_calls == {"rmsnorm": 1} and outer.cost.dot_flops == 0
    assert _costs.COUNTERS == []


POLICY = {"microbatches": 1, "fsdp_only": [], "batch_both_axes": False, "embed_single_axis": False}


@pytest.mark.parametrize("arch,kind", [
    ("mamba2-370m", "prefill"), ("phi4-mini-3.8b", "decode"), ("zamba2-1.2b", "prefill"),
    ("seamless-m4t-large-v2", "decode"), ("deepseek-v2-236b", "decode"),
    ("granite-moe-3b-a800m", "train"),
])
def test_one_block_times_length_equals_the_full_trace(arch, kind):
    """On a reduced 4-layer model (zamba2: 2 groups of 2 and one more block;
    seamless: 3 encoder and 4 decoder layers) the extension equals the full
    trace, to the FLOP and the byte."""
    cfg = get_config(arch).reduced()
    cfg = dataclasses.replace(cfg, num_layers=5 if cfg.family == "hybrid" else 4)
    if cfg.family == "hybrid":
        cfg = dataclasses.replace(cfg, hybrid_attn_every=2)
    if cfg.family == "audio":
        cfg = dataclasses.replace(cfg, encoder_layers=3)
    shape = InputShape("t", 32, 4, kind)
    with fake_world(4):
        mesh = make_debug_mesh((2, 2))
        full = dryrun.trace_pair(cfg, shape, mesh, POLICY, full_depth=True)
        ext = dryrun.trace_pair(cfg, shape, mesh, POLICY)
    assert ext.dot_flops == full.dot_flops > 0
    assert ext.traffic_bytes == full.traffic_bytes
    assert ext.collective_bytes == full.collective_bytes
    assert ext.collective_counts == full.collective_counts
    assert ext.while_trip_counts == {
        "ssm": [4], "dense": [4], "hybrid": [2, 1], "audio": [3, 4],
        "moe": [3] if cfg.mla is not None else [4],  # deepseek: dense0, then 3 MoE blocks
    }[cfg.family]


def test_roofline_terms_bottleneck():
    t = roofline_terms({"dot_flops": HW.peak_flops, "traffic_bytes": 1e9, "collective_bytes": 0})
    assert t["bottleneck"] == "compute"
    assert t["compute_s"] == pytest.approx(1.0)
    t2 = roofline_terms({"dot_flops": 1e9, "traffic_bytes": HW.hbm_bw, "collective_bytes": 0})
    assert t2["bottleneck"] == "memory" and t2["memory_s"] == pytest.approx(1.0)
    t3 = roofline_terms({"dot_flops": 1e9, "traffic_bytes": 1e9, "collective_bytes": HW.ici_bw})
    assert t3["bottleneck"] == "collective"
