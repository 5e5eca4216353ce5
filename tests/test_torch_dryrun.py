"""The port's dry run and roofline against the reference's on the CPU:

  * `repro_torch.roofline.analysis`: `_shape_bytes`, `_wire_bytes` (every
    kind, groups 1, 2, 16, 256), `collective_bytes_from_hlo` (hand-written
    HLO lines: every kind, the -start forms, tuple results, both
    replica_groups forms, the default group) and `roofline_terms` equal
    the reference's, the reference's `HW` set to the port's H100 values;
    `collective_bytes_from_records` prices records as the HLO parser
    prices the same ops;
  * `repro_torch.roofline.report`: `load_cells`, `markdown_table` and
    `summary` equal the reference's on the same cells (one a
    sharding-proof run with no roofline, one over HBM);
  * `run_cell` at smoke size (a dense train cell, a dense decode cell, a
    MoE cell): the reference's JSON keys, no process group left after a
    cell (one that raised too), a group that already exists refused,
    per-device param bytes from the PartitionSpec trees and the (16, 16)
    axis sizes; one MoE layer's collective records under the fake mesh;
    a dense train cell counted as rank 0's split step: its FLOPs times
    the chips against the whole step's, its sequence transitions over
    `model` and FSDP gathers over `data` by pass, the heads gathered
    where they do not divide;
  * the `meta` routes of the flash and paged wrappers: the plain
    versions' shapes and dtypes, their tallies by formula; the counting
    modes on a matmul, views and in-place ops;
  * the CLI and the report on its cell, in a subprocess.

The reference's `repro.launch.dryrun` is never imported here: it sets
XLA_FLAGS when imported, which would reach every later jax start in the
worker.  The last test checks that XLA_FLAGS is unchanged.
"""
import dataclasses as dc
import json
import math
import os
import pathlib
import subprocess
import sys

import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as ref_config
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_batch_specs
from repro_torch.kernels import counting
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.paged_attention.ref import paged_attention_plain
from repro_torch.launch import dryrun
from repro_torch.launch.shapes import SHAPES
from repro_torch.launch.steps import (_is_spec_leaf, abstract_opt_state,
                                      abstract_params, make_train_step)
from repro_torch.nn.model import param_specs
from repro_torch.roofline import analysis, report
from repro_torch.tree import tree_leaves

ROOT = pathlib.Path(__file__).resolve().parents[1]
XLA_FLAGS_AT_IMPORT = os.environ.get("XLA_FLAGS")
KINDS = analysis._COLL_KINDS

# the reference's keys of a cell (src/repro/launch/dryrun.py:245-258)
CELL_KEYS = {"arch", "shape", "mesh", "chips", "smoke", "lower_s",
             "compile_s", "memory_analysis", "per_device_bytes",
             "per_device_gb", "fits_hbm", "collective_ops_full_hlo",
             "probe", "roofline"}
MEM_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
            "temp_size_in_bytes", "generated_code_size_in_bytes",
            "alias_size_in_bytes"}


# ------------------------------------------------------------- analysis
def test_hw_is_one_h100():
    assert analysis.HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12,
                           "link_bw": 450e9, "hbm_bytes": 80 * 1000**3}
    assert set(analysis.HW) == set(ref_analysis.HW)
    assert analysis._DTYPE_BYTES == ref_analysis._DTYPE_BYTES
    assert analysis._COLL_KINDS == ref_analysis._COLL_KINDS


@pytest.mark.parametrize("dtype", sorted(ref_analysis._DTYPE_BYTES)
                         + ["token", "f8e4m3"])
def test_shape_bytes_matches_reference(dtype):
    for dims in ("", "7", "2,3,5", "1,0,4", "128,4096"):
        assert analysis._shape_bytes(dtype, dims) == \
            ref_analysis._shape_bytes(dtype, dims)


@pytest.mark.parametrize("kind", KINDS)
def test_wire_bytes_matches_reference(kind):
    for group in (1, 2, 16, 256):
        for rbytes in (0, 1, 4096, 3 * 2**30 + 7):
            assert analysis._wire_bytes(kind, rbytes, group) == \
                ref_analysis._wire_bytes(kind, rbytes, group)


HLO = "\n".join([
    "HloModule m, entry_computation_layout={(bf16[8,128]{1,0})->f32[]}",
    "  %p = bf16[8,128]{1,0} parameter(0)",
    "  %ag = bf16[16,128]{1,0} all-gather(bf16[8,128]{1,0} %p), "
    "channel_id=1, replica_groups=[16,16]<=[256], dimensions={0}",
    "  %ags = bf16[16,128]{1,0} all-gather-start(%p), "
    "replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}",
    "  %ar = f32[1024]{0} all-reduce(f32[1024]{0} %x), replica_groups={}, "
    "to_apply=%add",
    "  %ars = (f32[4]{0}, bf16[2,2]{1,0}) all-reduce-start(%a, %b), "
    "replica_groups=[2,128]<=[256], to_apply=%add",
    "  %rs = bf16[64,32]{1,0} reduce-scatter(bf16[1024,32]{1,0} %y), "
    "replica_groups=[16,16]<=[16,16]T(1,0), dimensions={0}",
    "  %a2a = (s8[4,64]{1,0}, s8[4,64]{1,0}) all-to-all(%u, %v), "
    "replica_groups={{0,1}}",
    "  %cp = u32[3,3]{1,0} collective-permute(%z), "
    "source_target_pairs={{0,1},{1,0}}",
    "  %cps = pred[9]{0} collective-permute-start(%w), channel_id=3",
    "  %done = bf16[16,128]{1,0} all-gather-done(%ags)",
    "  %add = f32[] add(f32[] %l, f32[] %r)",
    "  ROOT %t = f32[] constant(0)",
])


@pytest.mark.parametrize("default_group", [2, 16, 256])
def test_collective_bytes_from_hlo_matches_reference(default_group):
    got = analysis.collective_bytes_from_hlo(HLO, default_group)
    want = ref_analysis.collective_bytes_from_hlo(HLO, default_group)
    assert got == want
    assert got["n_all-gather"] == 2 and got["n_collective-permute"] == 2
    assert got["total"] > 0


def test_records_price_as_the_hlo_parser_does():
    """The same ops as records and as HLO lines: the same dict."""
    ops = [("all-gather", "bf16", "16,128", 16),
           ("all-reduce", "f32", "1024", 0),
           ("reduce-scatter", "bf16", "64,32", 16),
           ("all-to-all", "s8", "4,64", 2),
           ("collective-permute", "u32", "3,3", 0),
           ("all-reduce", "f32", "4", 256)]
    lines = []
    for kind, dt, dims, group in ops:
        groups = (f"replica_groups=[{256 // group},{group}]<=[256]"
                  if group else "replica_groups={}")
        lines.append(f"  %x = {dt}[{dims}]{{0}} {kind}(%a), {groups}")
    records = [(kind, analysis._shape_bytes(dt, dims), group)
               for kind, dt, dims, group in ops]
    for default in (2, 256):
        assert analysis.collective_bytes_from_records(records, default) == \
            ref_analysis.collective_bytes_from_hlo("\n".join(lines), default)
    empty = analysis.collective_bytes_from_records([])
    assert empty == ref_analysis.collective_bytes_from_hlo("")


@pytest.mark.parametrize("hlo", ["", HLO])
def test_roofline_terms_match_reference_with_h100_peaks(monkeypatch, hlo):
    for k, v in analysis.HW.items():
        monkeypatch.setitem(ref_analysis.HW, k, v)
    for cost in ({"flops": 3.1e15, "bytes accessed": 2.2e12}, None,
                 {"flops": 1e9, "bytes accessed": 7e12}):
        kw = dict(arch="qwen3-32b", shape="train_4k", mesh_name="pod16x16",
                  chips=256, cost_analysis=cost, hlo_text=hlo,
                  model_flops_global=5.5e17)
        got = analysis.roofline_terms(**kw).as_dict()
        assert got == ref_analysis.roofline_terms(**kw).as_dict()
    assert ref_analysis.HW["peak_flops"] == 989e12


# --------------------------------------------------------------- report
def _cell(arch, shape, mesh, gb, fits, roof):
    return {"arch": arch, "shape": shape, "mesh": mesh,
            "per_device_gb": gb, "fits_hbm": fits, "roofline": roof}


def _roof(compute, memory, coll, useful):
    terms = {"compute": compute, "memory": memory, "collective": coll}
    return {"compute_s": compute, "memory_s": memory, "collective_s": coll,
            "dominant": max(terms, key=terms.get),
            "useful_flops_ratio": useful}


CELLS = [
    _cell("qwen3-32b", "train_4k", "pod16x16", 41.7, True,
          _roof(2.5, 0.75, 0.31, 0.82)),
    _cell("qwen3-32b", "train_4k", "pod2x16x16", 22.1, True, None),
    _cell("yi-34b", "decode_32k", "pod16x16", 97.3, False,
          _roof(0.0004, 0.021, 1.7, 0.003)),
    _cell("gemma-7b", "prefill_32k", "pod16x16", 12.0, True,
          _roof(0.9, 1.2, 0.08, 0.41)),
    _cell("xlstm-350m", "long_500k", "pod2x16x16", 0.4, True, None),
]


def test_report_matches_reference(tmp_path):
    assert report.markdown_table(CELLS) == ref_report.markdown_table(CELLS)
    assert report.summary(CELLS) == ref_report.summary(CELLS)
    assert "over-HBM cells: yi-34b×decode_32k×pod16x16" in \
        report.summary(CELLS)
    assert report.summary(CELLS[1:2]) == ref_report.summary(CELLS[1:2])
    for i, c in enumerate(CELLS):
        (tmp_path / f"{i}.json").write_text(json.dumps(c))
    assert report.load_cells(str(tmp_path)) == \
        ref_report.load_cells(str(tmp_path))
    for x in (None, 0.0, 0.00042, 0.5, 1.0, 37.25):
        assert report.fmt_s(x) == ref_report.fmt_s(x)


# -------------------------------------------------------------- run_cell
def _expected_param_bytes(cfg, sizes):
    """Per-device bytes of the params from the spec trees alone: each dim
    over its logical axis' mesh size (fsdp -> data, tp -> model), rounded
    up."""
    axis = {"fsdp": sizes["data"], "tp": sizes["model"]}
    specs = tree_leaves(param_specs(cfg), is_leaf=_is_spec_leaf)
    total = 0
    for t, spec in zip(tree_leaves(abstract_params(cfg)), specs):
        shape = [-(-n // axis.get(a, 1)) for n, a in zip(t.shape, spec)]
        total += math.prod(shape) * t.element_size()
    return total


def _check_cell(cell, arch, shape, multi_pod):
    assert CELL_KEYS <= set(cell)
    assert set(cell["memory_analysis"]) == MEM_KEYS
    assert cell["arch"] == arch and cell["shape"] == shape
    assert cell["chips"] == (512 if multi_pod else 256)
    assert cell["mesh"] == ("pod2x16x16" if multi_pod else "pod16x16")
    assert cell["compile_s"] == 0.0 and cell["count"] == "meta, unfused"
    mem = cell["memory_analysis"]
    assert mem["generated_code_size_in_bytes"] is None
    assert mem["temp_size_in_bytes"] is not None
    assert cell["per_device_bytes"] == (
        mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
        + mem["output_size_in_bytes"] - mem["alias_size_in_bytes"])
    assert set(cell["collective_ops_full_hlo"]) == {f"n_{k}" for k in KINDS}
    assert not dist.is_initialized()
    json.dumps(cell)


def test_run_cell_dense_train():
    cfg = get_config("minicpm-2b", smoke=True)
    cell = dryrun.run_cell("minicpm-2b", "train_4k", multi_pod=False,
                           smoke=True)
    _check_cell(cell, "minicpm-2b", "train_4k", False)
    roof, probe = cell["roofline"], cell["probe"]
    assert roof["dominant"] in ("compute", "memory", "collective")
    assert roof["flops_per_device"] > 0 and roof["bytes_per_device"] > 0
    assert probe["probe_depths"] == (cfg.n_layers,)
    assert roof["flops_per_device"] == probe["flops"]
    # 128 x 16 tokens a step, 6 FLOPs a param a token
    assert roof["model_flops_global"] == 6.0 * cfg.active_param_count() \
        * 128 * 16 == 6.0 * ref_config("minicpm-2b", smoke=True) \
        .active_param_count() * 128 * 16
    assert cell["kernel_calls"] == {"flash_attention": 2 * cfg.n_layers}
    # params (bf16) + AdamW's f32 moments + its step + the tokens over
    # 'data'; the donated params and moments alias the outputs
    mem = cell["memory_analysis"]
    p = _expected_param_bytes(cfg, {"data": 16, "model": 16})
    assert mem["argument_size_in_bytes"] == 5 * p + 4 + 128 * 16 * 4 // 16
    assert mem["alias_size_in_bytes"] == 5 * p + 4
    colls = cell["collective_ops_full_hlo"]
    assert colls["n_all-gather"] > 0 and colls["n_reduce-scatter"] > 0
    assert colls["n_all-to-all"] == 0


def test_run_cell_dense_decode_multi_pod():
    cfg = get_config("gemma-7b", smoke=True)
    cell = dryrun.run_cell("gemma-7b", "decode_32k", multi_pod=True,
                           smoke=True)
    _check_cell(cell, "gemma-7b", "decode_32k", True)
    assert cell["roofline"] is None and cell["probe"] is None
    assert cell["kernel_calls"] == {"paged_attention": cfg.n_layers}
    mem = cell["memory_analysis"]
    assert mem["alias_size_in_bytes"] > 0          # the donated caches
    p = _expected_param_bytes(cfg, {"data": 16, "model": 16})
    assert mem["argument_size_in_bytes"] > p
    assert cell["collective_ops_full_hlo"]["n_reduce-scatter"] == 0


def test_run_cell_moe_prefill():
    cell = dryrun.run_cell("deepseek-v2-lite-16b", "prefill_32k",
                           multi_pod=False, smoke=True)
    _check_cell(cell, "deepseek-v2-lite-16b", "prefill_32k", False)
    assert cell["roofline"]["collectives"]["total"] > 0
    # the smoke config's 8 experts do not split over 16 model ranks
    assert any("do not split" in n for n in cell["collectives_not_counted"])
    assert cell["memory_analysis"]["alias_size_in_bytes"] == 0


def test_moe_records_under_the_fake_mesh():
    """deepseek's smoke config with 16 experts: one MoE layer's gathers,
    all-to-alls and all-reduces, forward twice and backward in training."""
    cfg = dc.replace(get_config("deepseek-v2-lite-16b", smoke=True),
                     n_experts=16)
    ap = abstract_params(cfg)
    n_moe = sum(cfg.layer_is_moe)
    got = {}
    for kind in ("train_4k", "prefill_32k", "decode_32k"):
        spec = dc.replace(SHAPES[kind], seq_len=128, global_batch=16)
        with dryrun.fake_mesh(False) as mesh:
            records, note = dryrun.moe_records(cfg, spec, ap, mesh)
        assert note is None and not dist.is_initialized()
        got[kind] = {k: sum(1 for r in records if r[0] == k) / n_moe
                     for k in KINDS}
        assert all(g == 16 for _, _, g in records)
    # forward: 3 weight gathers, the output over model and over data, 2
    # exchanges, the aux sums over both axes; backward: 5 exchanges, of
    # which the 3 weight gathers' are reduce-scatters (lax.all_gather's
    # transpose)
    assert got["prefill_32k"] == {"all-gather": 5, "all-reduce": 2,
                                  "reduce-scatter": 0, "all-to-all": 2,
                                  "collective-permute": 0}
    assert got["train_4k"] == {"all-gather": 10, "all-reduce": 4,
                               "reduce-scatter": 3, "all-to-all": 6,
                               "collective-permute": 0}
    # decode: replicated tokens, the partial sums and aux all-reduced
    assert got["decode_32k"]["all-to-all"] == 0
    assert got["decode_32k"]["all-reduce"] == 4


def test_a_cell_that_raises_leaves_no_group(monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "param_records", boom)
    with pytest.raises(RuntimeError, match="boom"):
        dryrun.run_cell("minicpm-2b", "decode_32k", multi_pod=False,
                        smoke=True)
    assert not dist.is_initialized()


def test_an_existing_group_is_refused_and_left_alone():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(RuntimeError, match="already initialized"):
            dryrun.run_cell("minicpm-2b", "decode_32k", multi_pod=False,
                            smoke=True)
        assert dist.is_initialized() and dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


# ------------------------------------------------------------ meta routes
def _brute_pairs(Sq, Skv, causal):
    if not causal:
        return Sq * Skv
    return int((torch.arange(Skv)[None, :]
                <= torch.arange(Sq)[:, None]).sum())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("Sq,Skv,D", [(37, 37, 64), (16, 40, 80),
                                       (50, 20, 8)])
def test_flash_meta_route(causal, Sq, Skv, D):
    B, H, Hkv = 2, 4, 2
    g = torch.Generator().manual_seed(Sq + D)
    q = torch.randn(B, Sq, H, D, generator=g).bfloat16()
    k = torch.randn(B, Skv, Hkv, D, generator=g).bfloat16()
    v = torch.randn(B, Skv, Hkv, D, generator=g).bfloat16()
    want, want_lse = flash_attention_plain(q, k, v, causal, return_lse=True)
    mq, mk, mv = (t.to("meta") for t in (q, k, v))
    with counting() as tally:
        o = flash_attention(mq, mk, mv, causal=causal)
        o2, lse = flash_attention(mq, mk, mv, causal=causal, return_lse=True)
    for got, ref in ((o, want), (o2, want), (lse, want_lse)):
        assert got.device.type == "meta"
        assert got.shape == ref.shape and got.dtype == ref.dtype
    assert flash_attention.launches == 0
    flops = 4 * B * H * D * _brute_pairs(Sq, Skv, causal)
    # bf16 q read and o written, k and v read, each call; f32 lse once
    io = 2 * (2 * B * Sq * H * D + 2 * B * Skv * Hkv * D)
    assert tally == {"flops": 2 * flops, "bytes": 2 * io + 4 * B * H * Sq,
                     "flash_attention": 2}
    flash_attention(mq, mk, mv, causal=causal)     # no tally open: no-op


def test_paged_meta_route():
    B, H, Hkv, D, P, page, T = 3, 8, 2, 64, 12, 4, 5
    g = torch.Generator().manual_seed(5)
    q = torch.randn(B, H, D, generator=g).bfloat16()
    kp = torch.randn(P, page, Hkv, D, generator=g).bfloat16()
    vp = torch.randn(P, page, Hkv, D, generator=g).bfloat16()
    tables = torch.randint(0, P, (B, T), dtype=torch.int32, generator=g)
    pos = torch.tensor([3, 19, 10], dtype=torch.int32)
    want = paged_attention_plain(q, kp, vp, tables, pos)
    with counting() as tally:
        o = paged_attention(*(t.to("meta") for t in (q, kp, vp, tables,
                                                       pos)))
    assert o.device.type == "meta"
    assert o.shape == want.shape and o.dtype == want.dtype
    positions = B * T * page
    assert tally == {"flops": 4 * H * D * positions,
                     "bytes": 2 * positions * Hkv * D * 2 + 2 * B * H * D * 2
                     + B * T * 4 + B * 4, "paged_attention": 1}
    assert paged_attention.launches == 0


def test_counting_modes_on_a_matmul():
    a = torch.empty(64, 32, dtype=torch.bfloat16, device="meta")
    b = torch.empty(32, 16, dtype=torch.bfloat16, device="meta")
    with dryrun.counting_step() as c:
        y = a @ b                       # 2 M N K, reads a and b, writes y
        y.t().reshape(-1)               # a view and a copy
        y.add_(1.0)                     # reads y, writes y
        torch.empty(1024, device="meta")
    assert c["flops"] == 2 * 64 * 16 * 32
    yb = 64 * 16 * 2
    assert c["bytes"] == (64 * 32 + 32 * 16) * 2 + yb + 2 * yb + 2 * yb
    assert c["peak"] == 2 * yb          # y and the reshape's copy
    assert c["kernels"] == {}


# -------------------------------------------------------------- the CLI
def test_cli_cell_and_report(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cells = tmp_path / "cells"
    cells.mkdir()
    out = cells / "minicpm-2b__train_4k__pod16x16.json"
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                        "--arch", "minicpm-2b", "--shape", "train_4k",
                        "--smoke", "--out", str(out)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    cell = json.loads(out.read_text())
    assert cell["chips"] == 256 and cell["smoke"] is True
    assert cell["roofline"]["dominant"] in ("compute", "memory",
                                            "collective")
    assert cell["memory_analysis"]["temp_size_in_bytes"] is not None
    r = subprocess.run([sys.executable, "-m", "repro_torch.roofline.report",
                        "--dir", str(cells)], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip() == "\n\n".join(
        [ref_report.markdown_table([cell]), ref_report.summary([cell])])
    assert "cells: 1 total, 1 with roofline" in r.stdout


def test_xla_flags_unchanged():
    assert os.environ.get("XLA_FLAGS") == XLA_FLAGS_AT_IMPORT
    assert not dist.is_initialized()


# ------------------------------------------------------ the dense split
def test_run_cell_split_train_counts_rank_zero(monkeypatch):
    """A dense GQA train cell counts rank 0's split step on the (16, 16)
    mesh: gemma-7b smoke with 16 query and KV heads, so every dim of the
    step splits over the mesh.  Its FLOPs times the chips are the whole
    step's within 2%; its collectives are the ones the step issues, by
    mesh axis: over `model`, a sequence gather and a scatter around
    attention and around the MLP, 4 a layer in the forward pass and 4 in
    the backward (each one's transpose), 3 in the remat's recomputation
    (it stops after the last tensor the backward needs, before the MLP's
    scatter), and one of each for the embedding and the loss; over
    `data`, the FSDP gathers of the 7 matrices a layer in the forward and
    the recomputation and of the table twice (the embedding, the loss),
    each with its gradient's reduce-scatter."""
    cfg = dc.replace(get_config("gemma-7b", smoke=True), n_heads=16,
                     n_kv_heads=16, head_dim=8)
    monkeypatch.setattr(dryrun, "get_config", lambda arch, smoke=False: cfg)
    cell = dryrun.run_cell("gemma-7b", "train_4k", multi_pod=False,
                           smoke=True)
    _check_cell(cell, "gemma-7b", "train_4k", False)
    ap = abstract_params(cfg)
    _, whole, _ = dryrun.count_step(
        make_train_step(cfg), (ap, abstract_opt_state(ap),
                               make_batch_specs(cfg, DataConfig(128, 16)), 1),
        train=True)
    assert abs(cell["probe"]["flops"] * 256 - whole["flops"]) \
        <= 0.02 * whole["flops"]
    assert cell["roofline"]["flops_per_device"] == cell["probe"]["flops"]
    assert cell["collectives_not_counted"] == []
    assert cell["dense_split"]["attention"] == "query heads split over model"
    assert cell["dense_split"]["q_heads_per_rank"] == 1
    L = cfg.n_layers
    model, data = (cell["collectives_by_axis"][a] for a in ("model", "data"))
    assert model["n_all-gather"] == (2 + 2 + 2) * L + 2
    assert model["n_reduce-scatter"] == (2 + 1 + 2) * L + 2
    assert model["n_all-gather"] + model["n_reduce-scatter"] \
        == (4 + 3 + 4) * L + 4
    assert data["n_all-gather"] == 2 * 7 * L + 2
    assert data["n_reduce-scatter"] == 7 * L + 2
    assert cell["kernel_calls"] == {"flash_attention": 2 * L}
    assert sum(cell["collectives_by_axis"][a]["total"]
               for a in ("data", "model")) == pytest.approx(
        cell["roofline"]["collectives"]["total"])


def test_run_cell_split_gathers_heads_that_do_not_divide():
    """minicpm-2b smoke's 4 heads do not split over 16 model ranks: each
    model rank computes every head (the attention weights gathered over
    `model` too) and keeps its sequence block, so attention's FLOPs are
    16 times its share and its output takes no scatter."""
    cell = dryrun.run_cell("minicpm-2b", "train_4k", multi_pod=False,
                           smoke=True)
    split = cell["dense_split"]
    assert split["q_heads_per_rank"] == 4 and split["model"] == 16
    assert split["attention"].startswith("every head on each model rank")
    L = get_config("minicpm-2b", smoke=True).n_layers
    model = cell["collectives_by_axis"]["model"]
    # a layer: the sequence gathers before attention and the MLP and the
    # 4 attention weights' gathers, in the forward pass and again in the
    # recomputation, the MLP's scatter (forward only: the recomputation
    # stops before it); in the backward each one's transpose
    assert model["n_all-gather"] == (6 + 6 + 1) * L + 2
    assert model["n_reduce-scatter"] == (1 + 0 + 6) * L + 2


# -------------------------------------------------------- the MoE split
def test_run_cell_split_moe_train_counts_rank_zero(monkeypatch):
    """A MoE train cell counts rank 0's split step on the (16, 16) mesh:
    deepseek smoke widened to 16 MLA heads and 16 experts, so every dim
    of the step splits over the mesh (one head and one expert a rank).
    With the capacity factor at n_experts / moe_topk no token drops, and
    rank 0's FLOPs times the chips are the whole step's plus the latents
    every model rank makes again (`w_dkv` and `w_kr` are whole over
    `model`: 15 more copies of their products, in the forward pass, the
    recomputation and the backward's two), within 0.5%.  Its collectives
    are the ones the step issues, with the MoE layer's all-to-alls over
    `model`: one each way in the forward pass, the recomputation and the
    backward."""
    base = get_config("deepseek-v2-lite-16b", smoke=True)
    cfg = dc.replace(base, n_heads=16, n_kv_heads=16, n_experts=16,
                     capacity_factor=16 / base.moe_topk)
    monkeypatch.setattr(dryrun, "get_config", lambda arch, smoke=False: cfg)
    cell = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k",
                           multi_pod=False, smoke=True)
    _check_cell(cell, "deepseek-v2-lite-16b", "train_4k", False)
    assert cell["collectives_not_counted"] == []
    assert cell["dense_split"]["experts_per_rank"] == 1
    assert cell["dense_split"]["q_heads_per_rank"] == 1
    ap = abstract_params(cfg)
    B, S = 16, 128
    _, whole, _ = dryrun.count_step(
        make_train_step(cfg), (ap, abstract_opt_state(ap),
                               make_batch_specs(cfg, DataConfig(S, B)), 1),
        train=True)
    latents = 2 * B * S * cfg.d_model * (cfg.kv_lora_rank + cfg.qk_rope_dim)
    want = whole["flops"] + 15 * 4 * latents * cfg.n_layers
    assert abs(cell["probe"]["flops"] * 256 - want) <= 0.005 * want
    n_moe = sum(cfg.layer_is_moe)
    model = cell["collectives_by_axis"]["model"]
    assert model["n_all-to-all"] == 6 * n_moe
    assert cell["collectives_by_axis"]["data"]["n_all-to-all"] == 0
    assert cell["kernel_calls"] == {"flash_attention": 2 * cfg.n_layers}


def test_run_cell_moe_train_that_does_not_place_evenly():
    """deepseek smoke's 8 experts do not split over 16 model ranks: its
    train cell counts the whole step over the chips, as the cells whose
    layers do not split, and names what that leaves out."""
    cell = dryrun.run_cell("deepseek-v2-lite-16b", "train_4k",
                           multi_pod=False, smoke=True)
    assert cell["dense_split"] is None
    assert any("do not split" in n for n in cell["collectives_not_counted"])
