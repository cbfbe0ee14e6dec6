"""The port's data-parallel primitives (fenerf_tpu_torch/train/sharding.py)
against fenerf_tpu/train/sharding.py's meaning, on the CPU: two gloo ranks
(tests/torch_ranks.py, launched once for every case) run shard_batch,
replicate, check_replica_consistency, the flat gradient sum, the top-k's
kept set decided across ranks and the host barrier; the per-rank layouts
of the batch and of a step's draws; world size 1 is free of collectives;
NCCL's refusal of more ranks than GPUs; and apps/train.py on two ranks
through --coordinator (checkpoint, resume, rank 0 alone writing, each
rank's share of the FID images as the JAX package deals them).
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from fenerf_tpu.eval import fid as jfid
from fenerf_tpu.train import sharding as jsharding
from fenerf_tpu_torch.apps import train as tcli
from fenerf_tpu_torch.train import curriculum as tcur
from fenerf_tpu_torch.train import loop as tloop
from fenerf_tpu_torch.train import sharding

import torch_ranks
from test_torch_train_step import tiny_texture_meta

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("prims")
    procs = torch_ranks.launch("prims", {}, out)
    return torch_ranks.collect(procs, "prims", out, timeout=120)


def test_shard_batch_is_each_ranks_contiguous_slice(ranks):
    glob = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["shard"], glob[4 * r:4 * r + 4])


def test_shard_batch_matches_jax_mesh_shards():
    """World 8: rank r holds the rows the JAX package's shard_batch puts on
    device r of the 8-device CPU mesh."""
    glob = np.random.default_rng(0).standard_normal((16, 3)).astype(
        np.float32)
    mesh = jsharding.data_mesh()
    arr = jsharding.shard_batch(mesh, glob)
    for shard in arr.addressable_shards:
        r = list(mesh.devices.reshape(-1)).index(shard.device)
        mine = sharding.shard_batch(sharding.Group(rank=r, world=8), glob)
        np.testing.assert_array_equal(mine.numpy(), np.asarray(shard.data))


def test_replicate_takes_rank_0s_values(ranks):
    for res in ranks:
        a, b, n = res["replicated"]
        np.testing.assert_array_equal(a, np.zeros(3, np.float32))
        np.testing.assert_array_equal(b, np.arange(4))
        assert n == res["rank"]          # counts are not tensors: kept


def test_check_replica_consistency_names_the_leaf(ranks):
    for res in ranks:
        assert "p/v" in res["diverged"] and "0.001" in res["diverged"]


def test_sum_tree_adds_the_ranks(ranks):
    for res in ranks:
        a, b = res["summed"]
        np.testing.assert_array_equal(a, np.full((2, 2), 3.0, np.float32))
        np.testing.assert_array_equal(b, np.full(3, 2.0, np.float32))


def test_topk_kept_set_spans_ranks(ranks):
    """Each rank's share of _chunk_topk_softplus, summed, is the one-process
    value on the whole chunks (frac 0.6 of 8: 5 kept, the kept set spread
    over both ranks), and each rank's gradient is its columns of the
    one-process gradient."""
    scores = torch.tensor(np.random.default_rng(0).standard_normal(
        (2, 8)).astype(np.float32), requires_grad=True)
    whole = tloop._chunk_topk_softplus(scores.reshape(-1), 0.6, 2)
    (grad,) = torch.autograd.grad(whole, scores)
    kept = (grad != 0).numpy()
    assert kept.sum() == 10 and kept[:, :4].any() and kept[:, 4:].any()
    shares = [res["topk"][0] for res in ranks]
    for res in ranks:
        np.testing.assert_allclose(res["topk"][1], whole.item(), rtol=1e-6)
    np.testing.assert_allclose(sum(shares), whole.item(), rtol=1e-6)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["topk"][2],
                                   grad[:, 4 * r:4 * r + 4].numpy(),
                                   rtol=1e-6, atol=0)


def test_host_barrier_deadline(ranks):
    """A late rank meets the others within the deadline; one that never
    arrives fails rank 0's barrier, which names it."""
    assert "missed" in ranks[0]["missed"]


def test_share_rows_layout():
    """Rank r's rows of each chunk, chunk by chunk; the ranks together
    cover the batch once."""
    assert sharding.share_rows(12, 2, 1, 3).tolist() == [2, 3, 8, 9]
    rows = torch.cat([sharding.share_rows(48, 4, r, 2) for r in range(2)])
    assert sorted(rows.tolist()) == list(range(48))
    with pytest.raises(ValueError, match="divisible"):
        sharding.share_rows(8, 2, 0, 3)


@pytest.mark.parametrize("full_batch", [False, True])
def test_shard_step_draws_takes_each_ranks_rows(full_batch):
    """Every leaf with a batch axis is sliced on it to the rank's rows of
    every microbatch; D_img's reals keep the rank's contiguous slice of the
    augmentation; the ray permutation stays whole."""
    meta = tiny_texture_meta(tcur, batch_size=8, full_batch=full_batch,
                             grad_rays=0.5,
                             diff_augment_policy="color,translation,cutout")
    g = torch.Generator().manual_seed(0)
    draws = tloop.make_step_draws(g, meta, 8, torch.tensor(0.5), "cpu")
    for r in range(2):
        local = sharding.shard_step_draws(draws, meta, 8, r, 2)
        rows = sharding.share_rows(8, 2, r, 2)
        for a, b in zip(local.z_g, draws.z_g):
            torch.testing.assert_close(a, b[rows], rtol=0, atol=0)
        whole = lambda parts, f: torch.cat([f(p) for p in parts])
        torch.testing.assert_close(
            whole(local.g_renders, lambda d: d.jitter),
            whole(draws.g_renders, lambda d: d.jitter)[rows], rtol=0, atol=0)
        torch.testing.assert_close(
            whole(local.fakes_seg, lambda d: d.noise.u),
            whole(draws.fakes_seg, lambda d: d.noise.u)[rows], rtol=0,
            atol=0)
        assert all(torch.equal(a.ray_perm, b.ray_perm) for a, b in
                   zip(local.g_renders, draws.g_renders))
        torch.testing.assert_close(local.aug_d[0], draws.aug_d[0][rows],
                                   rtol=0, atol=0)
        torch.testing.assert_close(local.aug_real[0],
                                   draws.aug_d[0][4 * r:4 * r + 4], rtol=0,
                                   atol=0)
        torch.testing.assert_close(
            whole(local.aug_g, lambda d: d[3][0]),
            whole(draws.aug_g, lambda d: d[3][0])[rows], rtol=0, atol=0)
        assert len(local.g_renders) == (1 if full_batch else 2)
    assert sharding.shard_step_draws(draws, meta, 8, 0, 1) is draws


def test_world_one_needs_no_process_group():
    group = sharding.Group()
    tree = {"w": torch.ones(2)}
    assert sharding.replicate(group, tree) is tree
    assert group.sum_tree(tree) is tree
    sharding.check_replica_consistency(group, tree)
    sharding.host_barrier(group, "alone", timeout_ms=1)
    assert not torch.distributed.is_initialized()


def test_nccl_needs_a_gpu_per_rank(monkeypatch):
    """More CUDA ranks than the host's visible GPUs are refused before any
    rendezvous: behind a coordinator on this host, or with torchrun's
    LOCAL_RANK beyond them."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_RANK", raising=False)
    with pytest.raises(RuntimeError, match="need 2 GPUs.*1 visible"):
        sharding.init_distributed("127.0.0.1:1", 2, 1)
    with pytest.raises(RuntimeError, match="need 2 GPUs.*1 visible"):
        sharding.init_distributed("tcp://localhost:1", 2, 0)
    monkeypatch.setenv("LOCAL_RANK", "1")
    with pytest.raises(RuntimeError, match="LOCAL_RANK 1 needs cuda:1.*1 "
                       "visible GPU"):
        sharding.init_distributed("10.0.0.1:1", 4, 3)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sharding.init_distributed("127.0.0.1:1", 2, 0)


@pytest.mark.parametrize("coordinator,world,rank,local_rank,gpu", [
    ("10.0.0.1:29500", 4, 0, None, 0),
    ("10.0.0.1:29500", 4, 3, None, 1),   # second host, its second GPU
    ("tcp://10.0.0.1:29500", 4, 2, None, 0),
    ("127.0.0.1:29500", 2, 1, None, 1),
    ("10.0.0.1:29500", 4, 3, "1", 1),    # torchrun's LOCAL_RANK
])
def test_rank_gpu_on_its_host(monkeypatch, coordinator, world, rank,
                              local_rank, gpu):
    """A CUDA rank's device: LOCAL_RANK where set, else the rank modulo the
    host's GPUs (2 here), so a --coordinator run over hosts puts each
    host's ranks on its own GPUs. The process group gets the barrier's
    deadline."""
    seen = {}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "set_device",
                        lambda d: seen.setdefault("set", d))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **kw: seen.update(kw))
    monkeypatch.setattr(torch.distributed, "new_group", lambda **kw: None)
    monkeypatch.setenv("FENERF_BARRIER_TIMEOUT_MS", "7000")
    if local_rank is None:
        monkeypatch.delenv("LOCAL_RANK", raising=False)
    else:
        monkeypatch.setenv("LOCAL_RANK", local_rank)
    group = sharding.init_distributed(coordinator, world, rank)
    assert group.device == seen["set"] == torch.device("cuda", gpu)
    assert seen["device_id"] == group.device
    assert (seen["rank"], seen["world_size"]) == (rank, world)
    assert seen["timeout"].total_seconds() == 7.0


def test_barrier_timeout_default_is_jaxs(monkeypatch):
    """FENERF_BARRIER_TIMEOUT_MS, default 1,200,000 ms, as the JAX
    package's host_barrier reads it."""
    seen = []
    monkeypatch.setattr(torch.distributed, "monitored_barrier",
                        lambda **kw: seen.append(kw["timeout"]))
    group = dataclasses.replace(sharding.Group(), world=2)
    monkeypatch.delenv("FENERF_BARRIER_TIMEOUT_MS", raising=False)
    sharding.host_barrier(group, "x")
    monkeypatch.setenv("FENERF_BARRIER_TIMEOUT_MS", "5")
    sharding.host_barrier(group, "y")
    assert [t.total_seconds() for t in seen] == [1200.0, 0.005]
    assert jax.process_count() == 1   # the JAX side's barrier: a no-op


# ---------------------------------------------------------------------------
# apps/train.py with two ranks
# ---------------------------------------------------------------------------

def _cli(r, port, out, jpgs, *extra):
    return [sys.executable, "-m", "fenerf_tpu_torch.apps.train",
            "--curriculum", "smoke_grid", "--device", "cpu", "--data_root",
            jpgs, "--coordinator", f"127.0.0.1:{port}", "--num_processes",
            "2", "--process_id", str(r), "--output_dir", str(out),
            "--log_every", "1", "--stage_overrides", '{"target_size": 16}',
            *extra]


def _two_ranks(tmp_path, outs, jpgs, *extra):
    env = {k: v for k, v in os.environ.items()
           if k not in ("FENERF_INCEPTION_WEIGHTS",)
           + tcli.TORCHRUN_ENV}
    env.update(PYTHONPATH=torch_ranks.REPO, OMP_NUM_THREADS="2")
    port = torch_ranks.free_port()
    procs = [subprocess.Popen(_cli(r, port, outs[r], jpgs, *extra),
                              env=env, cwd=str(tmp_path),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    return logs


def _files(d):
    return sorted(str(p.relative_to(d)) for p in Path(d).rglob("*")
                  if p.is_file())


def test_cli_two_ranks_train_resume_and_share_the_fid(tmp_path):
    """smoke_grid on two gloo ranks through --coordinator: batch_size 8 per
    rank (--batch_per_device), 2 steps with a checkpoint, samples and the
    FID's images (32: two batches of 16, one per rank, as the JAX
    package's output_images deals them; no Inception weights, so the score
    is skipped), then a resume to step 3. Rank 1 gets an output directory of
    its own: it holds its share of the FID images and nothing else."""
    src = Path(__file__).resolve().parent / "data" / "celebamask_synth"
    data = tmp_path / "jpgs"
    data.mkdir()
    for i in range(32):
        (data / f"{i:05d}.jpg").symlink_to(src / f"{i % 8:05d}.jpg")
    jpgs = str(data / "*.jpg")
    a, b = tmp_path / "a", tmp_path / "b"
    logs = _two_ranks(tmp_path, (a, b), jpgs, "--total_steps", "2",
                      "--model_save_interval", "2", "--sample_interval",
                      "2", "--eval_freq", "2", "--num_eval_imgs", "32")
    lines = [json.loads(x) for x in (a / "metrics.jsonl").read_text()
             .splitlines()]
    assert [x["step"] for x in lines] == [0, 1]
    assert all(math.isfinite(x["g_loss"]) for x in lines)
    assert "batch_size=16" in (a / "options.txt").read_text()
    assert "ranks=2" in logs[0] and "[stage]" not in logs[1]
    assert "[fid] skipped" in logs[0]
    for name in ("train_state.npz", "generator.npz", "2_img_fixed.png"):
        assert (a / name).exists(), name
    # each rank's share of the FID images: JAX's round robin
    for r, d in enumerate((a, b)):
        ref = tmp_path / f"jax{r}"
        jfid.output_images(lambda k, n: np.zeros((n, 3, 4, 4), np.float32),
                           str(ref), num_eval=32, host_index=r, n_hosts=2)
        mine = _files(d / "evaluation" / "generated")
        assert mine == sorted(os.listdir(ref)) and len(mine) == 16
        assert f"images=16 rank={r}" in logs[r]
    assert _files(b) == [f"evaluation/generated/{x}" for x in
                         sorted(os.listdir(tmp_path / "jax1"))]
    # resume: both ranks read rank 0's checkpoint
    a2, b2 = tmp_path / "a2", tmp_path / "b2"
    logs = _two_ranks(tmp_path, (a2, b2), jpgs, "--total_steps", "3",
                      "--load_dir", str(a), "--model_save_interval", "0",
                      "--sample_interval", "0", "--eval_freq", "0")
    assert "resumed from" in logs[0] and "resumed from" not in logs[1]
    lines = [json.loads(x) for x in (a2 / "metrics.jsonl").read_text()
             .splitlines()]
    assert [x["step"] for x in lines] == [2]
    with np.load(a2 / "train_state.npz") as st:
        n = json.loads(str(st["__manifest__"]))["n"]
        assert int(st[f"leaf_{n - 1}"]) == 3
    assert _files(b2) == []
