"""Rank processes for the port's data-parallel CPU tests
(tests/test_torch_sharding.py, tests/test_torch_train_ddp.py).

`launch(kind, job, out_dir)` starts `world` processes of this file, each
joining one gloo group over 127.0.0.1 through
fenerf_tpu_torch.train.sharding.init_distributed, with one torch thread;
each runs every case of the job (a torch.save'd dict) and writes
`<out_dir>/<kind>_rank<r>.pt`. `collect` waits for them (with a deadline)
and loads their results. The ranks import torch and the port only, never
JAX.
"""
import os
import socket
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(kind: str, job: dict, out_dir, world: int = 2):
    """Start the ranks of `kind` on `job`; returns their Popen handles."""
    out_dir = str(out_dir)
    path = os.path.join(out_dir, f"{kind}_job.pt")
    torch.save(job, path)
    port = free_port()
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep
               + os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="1")
    return [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), kind, str(r), str(world),
         str(port), path, out_dir], env=env, cwd=REPO,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]


def collect(procs, kind: str, out_dir, timeout: float = 300.0) -> list:
    """Wait for the ranks; fail with their output if one failed. Returns
    each rank's results, rank 0 first."""
    outs = []
    deadline = time.time() + timeout
    try:
        for p in procs:
            out, _ = p.communicate(timeout=max(1.0, deadline - time.time()))
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"
    res = []
    for r in range(len(procs)):
        path = os.path.join(str(out_dir), f"{kind}_rank{r}.pt")
        res.append(torch.load(path, weights_only=False))
        os.remove(path)
    return res


# ---------------------------------------------------------------------------
# What the ranks run
# ---------------------------------------------------------------------------

def _np_tree(tree):
    from fenerf_tpu_torch.compat.jax_bridge import tree_map

    return tree_map(lambda t: t.detach().numpy().copy(), tree)


def _train(group, job):
    """Each case: this rank's share of a step on the case's global batch
    and global draws, from the seed-0 state; then a second step on draws
    from a generator; the replicas checked after each."""
    from fenerf_tpu_torch.compat.jax_bridge import tree_leaves
    from fenerf_tpu_torch.train import loop as tloop
    from fenerf_tpu_torch.train import sharding

    out = []
    for case in job["cases"]:
        meta = case["meta"]
        state = tloop.init_train_state(meta, seed=0, device="cpu")
        imgs, labels = sharding.shard_batch(group, case["imgs"],
                                            case["labels"])
        state, m = sharding.train_step_sharded(
            state, imgs, labels, case["scal"], meta, group,
            draws=case["draws"])
        res = {"metrics": {k: float(v) for k, v in m.items()},
               "batch": int(imgs.shape[0])}
        if group.rank == 0:
            res["g_params"] = _np_tree(state.g_params)
            res["mu"] = {k: _np_tree(getattr(state, k).mu)
                         for k in ("opt_g", "opt_img", "opt_seg")}
        sharding.check_replica_consistency(group, state)
        state, m = sharding.train_step_sharded(
            state, imgs, labels, case["scal"], meta, group,
            generator=torch.Generator().manual_seed(7))
        try:
            sharding.check_replica_consistency(group, state)
            res["replicas"] = "identical"
        except AssertionError as e:
            res["replicas"] = str(e)
        res["step2_g"] = torch.cat([
            t.reshape(-1) for t in tree_leaves(state.g_params)]).numpy()
        res["step"] = state.step
        out.append(res)
    return out


def _prims(group, job):
    """The sharding primitives, one check each."""
    from fenerf_tpu_torch.train import sharding

    res = {"rank": group.rank, "world": group.world}
    glob = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    res["shard"] = sharding.shard_batch(group, glob).numpy()
    # replicate: rank 0's values win, in place, every dtype
    tree = {"a": torch.full((3,), float(group.rank)),
            "b": [torch.arange(4) + group.rank], "n": group.rank}
    sharding.replicate(group, tree)
    res["replicated"] = (tree["a"].numpy(), tree["b"][0].numpy(), tree["n"])
    # a diverged leaf is named; equal trees (NaN included) pass
    same = {"w": torch.tensor([1.0, float("nan")]), "x": torch.zeros(2)}
    sharding.check_replica_consistency(group, same)
    bad = {"p": {"w": torch.zeros(2), "v": torch.tensor([0.0, group.rank
                                                         * 1e-3])}}
    try:
        sharding.check_replica_consistency(group, bad)
        res["diverged"] = None
    except AssertionError as e:
        res["diverged"] = str(e)
    sharding.check_replica_consistency(group, bad, atol=1e-2)
    # the gradient sum: one flat f32 all-reduce over the tree
    g = {"k": [torch.full((2, 2), group.rank + 1.0), torch.ones(3)]}
    res["summed"] = [t.numpy() for t in group.sum_tree(g)["k"]]
    res["topk"] = _topk(group)
    # the host barrier: a rank that arrives late within the deadline
    # passes (the deadline from FENERF_BARRIER_TIMEOUT_MS); one that never
    # arrives fails it by name (the last collective of the job)
    if group.rank == 1:
        time.sleep(0.5)
    os.environ["FENERF_BARRIER_TIMEOUT_MS"] = "30000"
    sharding.host_barrier(group, "late")
    if group.rank == 0:
        try:
            sharding.host_barrier(group, "missed", timeout_ms=1_500)
            res["missed"] = None
        except RuntimeError as e:
            res["missed"] = str(e)
    else:
        time.sleep(4.0)
    return res


def _topk(group):
    """train/loop.py's top-k share of each rank on a fixed chunk layout,
    and its gradient w.r.t. the rank's scores."""
    from fenerf_tpu_torch.train import loop as tloop

    scores = torch.tensor(np.random.default_rng(0).standard_normal(
        (2, 8)).astype(np.float32))
    m = 8 // group.world
    mine = scores[:, group.rank * m:(group.rank + 1) * m].clone()
    mine.requires_grad_(True)
    share = tloop._chunk_topk_softplus(mine.reshape(-1), 0.6, 2, group)
    (grad,) = torch.autograd.grad(share, mine)
    total = group.all_reduce(share.detach().clone())
    return float(share), float(total), grad.numpy()


def main():
    kind, rank, world, port, job_path, out_dir = sys.argv[1:7]
    torch.set_num_threads(1)
    from fenerf_tpu_torch.train import sharding

    group = sharding.init_distributed(f"127.0.0.1:{port}", int(world),
                                      int(rank), device_type="cpu")
    job = torch.load(job_path, weights_only=False)
    try:
        res = {"train": _train, "prims": _prims}[kind](group, job)
    except Exception:
        traceback.print_exc()
        raise
    torch.save(res, os.path.join(out_dir, f"{kind}_rank{rank}.pt"))
    sharding.shutdown()


if __name__ == "__main__":
    main()
