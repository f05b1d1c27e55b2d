"""The port's dry-run (``repro_torch.launch.dryrun``): ``config_for``, the
CLI end to end in a subprocess (it owns its fake process group), the record
``benchmarks/roofline_table.py`` reads, and the head pins."""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmarks.roofline_table import summarize
from repro.configs import get_config as ref_get
from repro.models.model_zoo import build_model as ref_build
from repro_torch.configs import INPUT_SHAPES, get_config
from repro_torch.configs.base import InputShape
from repro_torch.launch import dryrun
from repro_torch.launch.dryrun import config_for
from repro_torch.launch.mesh import fake_world, make_debug_mesh
from repro_torch.models import spmd

ROOT = Path(__file__).resolve().parents[1]


def test_long500k_window_variants():
    shape = INPUT_SHAPES["long_500k"]
    assert config_for("llama3-405b", shape).attn_window == 4096
    assert config_for("gemma-7b", shape).attn_window == 4096
    assert config_for("mamba2-370m", shape).attn_window is None
    assert config_for("zamba2-1.2b", shape).attn_window == 4096  # shared attn
    assert config_for("llama3-405b", INPUT_SHAPES["train_4k"]).attn_window is None


def _ref_count(arch: str) -> int:
    import jax

    return sum(int(l.size) for l in jax.tree_util.tree_leaves(ref_build(ref_get(arch)).param_shapes()))


def test_cli_writes_the_reference_record(tmp_path):
    """The reference's integration pair: the record's keys and counts, read
    by ``roofline_table.summarize``; no CUDA initialised, nothing
    allocated."""
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", "mamba2-370m",
         "--shape", "long_500k", "--out", str(tmp_path)],
        env=env, capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.strip().splitlines()[-1].endswith("torch.cuda.is_initialized()=False")
    rec = json.loads((tmp_path / "mamba2-370m__long_500k__16x16.json").read_text())
    assert rec["mesh"] == "16x16" and rec["route"] == "plain" and rec["kind"] == "decode"
    assert rec["num_params"] > 1e8 and rec["num_params"] == _ref_count("mamba2-370m")
    for key in ("compute_s", "memory_s", "collective_s", "bottleneck"):
        assert key in rec["roofline"]
    ha = rec["hlo_analysis"]
    assert ha["dot_flops"] > 0 and ha["traffic_bytes"] > 0
    assert ha["while_trip_counts"] == [48]
    assert rec["collectives"]["total_bytes"] == ha["total_collective_bytes"]
    assert rec["memory_analysis"]["argument_size_in_bytes"] > 0
    row = summarize(rec)
    assert row and row["arch"] == "mamba2-370m" and row["bottleneck"] == rec["roofline"]["bottleneck"]


POLICY = {"microbatches": 1, "fsdp_only": [], "batch_both_axes": False, "embed_single_axis": False}


def _pins(monkeypatch):
    seen = []
    real = spmd.pin

    def pin(t, spec):
        seen.append((tuple(t.shape), tuple(spec)))
        return real(t, spec)

    monkeypatch.setattr(spmd, "pin", pin)
    return seen


@pytest.mark.parametrize("heads,kv,want", [
    (8, 2, ("data", None, None, "model", None)),   # G = 4 >= Hkv: the group dim
    (4, 4, ("data", None, "model", None, None)),   # G = 1 < Hkv: the kv heads
])
def test_shard_attn_heads_pins_the_grouped_query(monkeypatch, heads, kv, want):
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b").reduced(), num_heads=heads,
                              num_kv_heads=kv, shard_attn_heads=True)
    seen = _pins(monkeypatch)
    with fake_world(4):
        cost = dryrun.trace_step(cfg, InputShape("t", 32, 4, "prefill"), make_debug_mesh((2, 2)), POLICY)
    dh = cfg.resolved_head_dim
    assert ((4, 32, kv, heads // kv, dh), want) in seen
    assert cost.dot_flops > 0


def test_shard_ssm_heads_pins_xh_and_dt(monkeypatch):
    cfg = dataclasses.replace(get_config("mamba2-370m").reduced(), shard_ssm_heads=True)
    seen = _pins(monkeypatch)
    with fake_world(4):
        dryrun.trace_step(cfg, InputShape("t", 32, 4, "prefill"), make_debug_mesh((2, 2)), POLICY)
    d_inner = cfg.ssm.expand * cfg.d_model
    h = d_inner // cfg.ssm.head_dim
    assert ((4, 32, h, cfg.ssm.head_dim), ("data", None, "model", None)) in seen
    assert ((4, 32, h), ("data", None, "model")) in seen


def test_no_pin_without_the_flags(monkeypatch):
    """Without ``shard_ssm_heads`` the scan's heads follow ``in_proj``: whole
    when its output is whole over ``model`` (input-dim FSDP), split when
    it is split."""
    cfg = get_config("mamba2-370m").reduced()
    h = cfg.ssm.expand * cfg.d_model // cfg.ssm.head_dim
    pinned = ((4, 32, h, cfg.ssm.head_dim), ("data", None, "model", None))
    seen = _pins(monkeypatch)
    with fake_world(4):
        dryrun.trace_step(cfg, InputShape("t", 32, 4, "prefill"), make_debug_mesh((2, 2)),
                          {**POLICY, "fsdp_only": ["blocks"]})
    assert not any(spec == pinned[1] for _, spec in seen)
    seen.clear()
    with fake_world(4):
        dryrun.trace_step(cfg, InputShape("t", 32, 4, "prefill"), make_debug_mesh((2, 2)), POLICY)
    assert pinned in seen


def test_plain_tensors_take_no_pin(monkeypatch):
    """On one device (plain tensors) the pins return their input, as the
    reference's ``try/except`` does with no mesh in scope."""
    t = torch.zeros(2, 3)
    assert spmd.pin(t, ("data", None)) is t
    assert spmd.rows(t) is t and spmd.heads(t, 3) is t
    assert torch.equal(spmd.mm(t, torch.ones(3, 2)), t @ torch.ones(3, 2))


def test_pair_config_knobs_and_lower_only():
    cfg = dryrun.pair_config("mamba2-370m", INPUT_SHAPES["train_4k"], ssd_chunk=128,
                             shard_ssm_heads=True, params_bf16=True, shard_attn_heads=True)
    assert cfg.ssm.chunk == 128 and cfg.shard_ssm_heads and cfg.shard_attn_heads
    assert cfg.param_dtype == "bfloat16"
    rec = dryrun.dryrun_pair("mamba2-370m", "long_500k", lower_only=True, variant="probe")
    assert rec["variant"] == "probe" and rec["lower_s"] >= 0
    assert "hlo_analysis" not in rec and rec["num_params"] == _ref_count("mamba2-370m")
    assert not torch.distributed.is_initialized()
