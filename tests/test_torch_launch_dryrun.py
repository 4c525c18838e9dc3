"""The dry run's count against the reference's, and the dry run's CLIs
(``repro_torch.launch.{dryrun,roofline,hillclimb}``), on the CPU.

  * the port's FLOPs of the dense smoke train and decode steps (qwen at
    smoke width and one unit, sequence 64, batch 4, 2 particles, 2
    microbatches) are
    within 2% of ``repro.launch.hlo_cost.cost`` on the reference's 1 x 1
    compile (they are equal); the prefill differs by one named term: the
    prefill kernel (#5) charges the causal pairs it computes, S (S + 1) /
    2 a head, where the reference's compiled attention multiplies all S^2;
  * two full-size rows (qwen1.5-0.5b and rwkv6-7b x decode_32k on the
    single mesh) are "ok" with the record's keys, rwkv's layers on 16
    model positions; an "fsdp_tp" row (llama3-405b) fails naming item
    29; a SKIPS row is skipped;
  * ``roofline.analyze`` / ``markdown`` over those records on the H100's
    constants, ``hillclimb.measure`` and ``dryrun.main``'s files.
"""
import dataclasses
import json

import jax
import pytest
import torch

from repro import configs as jconfigs
from repro.configs import INPUT_SHAPES as JSHAPES
from repro.launch import hlo_cost
from repro.launch import mesh as jmesh
from repro.launch import steps as JS
from repro.launch.plans import plan_for as jplan_for
from repro_torch import configs as tconfigs
from repro_torch.configs import INPUT_SHAPES
from repro_torch.launch import cost as C
from repro_torch.launch import dryrun, hillclimb, make_mesh, roofline
from repro_torch.launch import steps as TS
from repro_torch.launch.plans import plan_for

ARCH = "qwen1.5-0.5b"


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _counts(shape):
    kw = dict(particles=2)
    if shape == "train_4k":
        kw["microbatches"] = 2
    jplan = dataclasses.replace(jplan_for(jconfigs.get(ARCH),
                                          JSHAPES[shape]), **kw)
    tplan = dataclasses.replace(plan_for(tconfigs.get(ARCH),
                                         INPUT_SHAPES[shape]), **kw)
    jm = jmesh.make_mesh((1, 1), ("data", "model"))
    with jax.set_mesh(jm):
        step, args, _ = JS.build(
            jconfigs.get(ARCH).smoke().replace(n_units=1), dataclasses.replace(
                JSHAPES[shape], seq_len=64, global_batch=4), jplan, jm)
        want = hlo_cost.cost(jax.jit(step).lower(*args).compile().as_text())
    step, args, _ = TS.build(
        tconfigs.get(ARCH).smoke().replace(n_units=1), dataclasses.replace(
            INPUT_SHAPES[shape], seq_len=64, global_batch=4), tplan,
        make_mesh((1, 1), ("data", "model"), TS.trace_devices(1)))
    return want, C.cost(step, *args)


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_flops_match_reference_hlo_cost(shape):
    want, got = _counts(shape)
    assert abs(got["flops"] / want["flops"] - 1.0) < 0.02


def test_prefill_flops_differ_by_the_kernels_causal_pairs():
    want, got = _counts("prefill_32k")
    cfg = tconfigs.get(ARCH).smoke().replace(n_units=1)
    S, per_pair = 64, 4 * 2 * 4 * cfg.n_heads * cfg.hd   # 4 P B H hd
    masked = per_pair * (S * S - S * (S + 1) // 2) * cfg.n_layers
    assert got["flops"] == want["flops"] - masked


@pytest.fixture(scope="module")
def records():
    return {"ok": dryrun.run_one(ARCH, "decode_32k", verbose=False),
            "fsdp": dryrun.run_one("llama3-405b", "train_4k",
                                   verbose=False),
            "rwkv": dryrun.run_one("rwkv6-7b", "decode_32k", verbose=False),
            "skip": dryrun.run_one(ARCH, "long_500k", verbose=False)}


def test_full_size_rows(records):
    ok = records["ok"]
    assert ok["status"] == "ok", ok.get("error")
    for key in ("particles", "mode", "microbatches", "param_dtype",
                "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "memory", "trace_s",
                "kv_layout", "card"):
        assert key in ok, key
    assert ok["kv_layout"] == "heads" and ok["chips"] == 256
    assert ok["local_particles"] == 4 and ok["local_batch"] == 128 // 16
    assert ok["flops_per_device"] > 0 and ok["bytes_per_device"] > 0
    assert ok["collective_bytes_per_device"]["all-reduce"] > 0
    assert ok["memory"]["argument_size_in_bytes"] > 1e9
    assert records["fsdp"]["status"] == "fail"
    assert "item 29" in records["fsdp"]["error"]
    rwkv = records["rwkv"]
    assert rwkv["status"] == "ok", rwkv.get("error")
    for key in ("particles", "mode", "flops_per_device", "bytes_per_device",
                "collective_bytes_per_device", "memory", "kv_layout"):
        assert key in rwkv, key
    assert rwkv["mode"] == "tp" and rwkv["chips"] == 256
    # the time-mix's wo and the channel-mix's wv partials are summed
    assert rwkv["collective_bytes_per_device"]["all-reduce"] > 0
    assert records["skip"]["status"] == "skip"


def test_roofline_hillclimb_and_files(records, tmp_path, monkeypatch):
    for name, rec in records.items():
        (tmp_path / f"{name}__single.json").write_text(json.dumps(rec))
    rows = roofline.analyze(str(tmp_path))
    ok = next(r for r in rows if r["status"] == "ok")
    h100 = roofline.CARDS["NVIDIA H100 80GB HBM3, 700.00 W"]
    assert ok["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    assert ok["t_compute_s"] == records["ok"]["flops_per_device"] / \
        h100["peak_flops"]
    assert ok["t_memory_s"] == records["ok"]["bytes_per_device"] / \
        h100["hbm_bw"]
    assert ok["dominant"] in ("compute", "memory", "collective")
    table = roofline.markdown(rows)
    assert "item 29" in table and "rwkv6-7b" in table
    dryrun.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--out",
                 str(tmp_path / "runs")])
    saved = json.loads((tmp_path / "runs" /
                        "rwkv6-7b__decode_32k__single.json").read_text())
    assert saved["status"] == "ok" and saved["flops_per_device"] == \
        records["rwkv"]["flops_per_device"]
    # hillclimb's terms over a smoke count (no full-size trace again)
    counted = _counts("decode_32k")[1]
    monkeypatch.setattr(C, "count", lambda *a, **k: (counted, None))
    rec = hillclimb.measure(ARCH, "decode_32k", top=True)
    assert rec["t_memory_s"] == counted["bytes"] / h100["hbm_bw"]
    assert rec["dominant"] in ("compute", "memory", "collective")
    assert rec["card"] == roofline.CARD
