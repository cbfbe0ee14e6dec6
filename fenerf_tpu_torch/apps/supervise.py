"""Hang / crash supervisor on the port: run a trainer under failure
detection with automatic checkpoint resume (counterpart of
fenerf_tpu/apps/supervise.py; host-only, the standard library alone).

The reference has no failure handling (SURVEY.md §5:
`train_double_latent_semantic.py` dies and loses everything since the last
manual restart). This CLI supervises any trainer command, typically
`python -m fenerf_tpu_torch.apps.train` (one process, or torchrun's
launcher for several):

  * liveness is progress, not "the process exists": the watched files
    (the trainer's metrics.jsonl) must gain mtime within --stall_s once
    --startup_grace_s (the first step's kernel builds) has passed; a live
    but wedged process is killed with its whole process group and counted
    as a stall;
  * a crash or a stall relaunches the SAME argv: the trainer's own
    --load_dir resume (apps/train.py) picks up from the last periodic
    checkpoint, so at most model_save_interval steps are trained again;
  * each attempt's stdout and stderr go to <log>.<attempt>;
  * events (launched / exit / stall_kill / relaunching / done / giving_up)
    append to <log>.events.jsonl.

Usage:
  python -m fenerf_tpu_torch.apps.supervise --log output/run.log \
      --watch output/run/metrics.jsonl --stall_s 600 --max_restarts 8 -- \
      python -m fenerf_tpu_torch.apps.train --curriculum ... \
          --output_dir output/run --load_dir output/run ...
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import time


def _log_event(path: str, **ev) -> None:
    ev["ts"] = round(time.time(), 1)
    with open(path, "a") as f:
        f.write(json.dumps(ev) + "\n")
    print(f"[supervise] {ev}", flush=True)


def _progress_mtime(watch: list[str], since: float) -> float | None:
    """The latest watched-file mtime not older than `since` (a previous
    attempt's files do not count as this attempt's progress)."""
    newest = None
    for p in watch:
        try:
            mt = os.stat(p).st_mtime
        except OSError:
            continue
        if mt >= since and (newest is None or mt > newest):
            newest = mt
    return newest


def _kill_group(proc: subprocess.Popen) -> None:
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def supervise(argv: list[str], log: str, watch: list[str], stall_s: float,
              startup_grace_s: float, poll_s: float,
              max_restarts: int) -> int:
    """Run `argv` until it exits 0 or fails more than `max_restarts`
    times; returns the supervisor's exit code (0 done, 1 gave up)."""
    events = log + ".events.jsonl"
    attempt = 0
    restarts = 0
    while True:
        attempt_log = f"{log}.{attempt}"
        env = dict(os.environ, PYTHONUNBUFFERED="1")
        started = time.time()
        with open(attempt_log, "w") as out:
            proc = subprocess.Popen(
                argv, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True, env=env)
        _log_event(events, event="launched", attempt=attempt, pid=proc.pid,
                   log=attempt_log)

        reason = None
        while True:
            rc = proc.poll()
            if rc is not None:
                if rc == 0:
                    _log_event(events, event="done", attempt=attempt,
                               restarts=restarts)
                    return 0
                reason = f"crash rc={rc}"
                _log_event(events, event="exit", attempt=attempt, rc=rc)
                break
            now = time.time()
            prog = _progress_mtime(watch, started)
            last = prog if prog is not None else started
            grace_over = now - started > startup_grace_s
            if grace_over and now - last > stall_s:
                reason = (f"stall: no progress on {watch} for "
                          f"{round(now - last)}s")
                _log_event(events, event="stall_kill", attempt=attempt,
                           idle_s=round(now - last), pid=proc.pid)
                _kill_group(proc)
                break
            time.sleep(poll_s)

        restarts += 1
        if restarts > max_restarts:
            _log_event(events, event="giving_up", attempt=attempt,
                       reason=reason, restarts=restarts - 1)
            return 1
        _log_event(events, event="relaunching", reason=reason,
                   next_attempt=attempt + 1)
        attempt += 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--log", required=True,
                   help="base path; attempt i writes <log>.<i>, events "
                        "append to <log>.events.jsonl")
    p.add_argument("--watch", action="append", default=None,
                   help="file(s) whose mtime is the liveness signal (the "
                        "trainer's metrics.jsonl); <log>.<attempt> itself "
                        "is not watched")
    p.add_argument("--stall_s", type=float, default=600.0,
                   help="kill the attempt if no watched file progressed "
                        "for this long (after the startup grace)")
    p.add_argument("--startup_grace_s", type=float, default=900.0,
                   help="never stall-kill within this long of a launch (a "
                        "fresh process builds its kernels before its "
                        "first metric)")
    p.add_argument("--poll_s", type=float, default=10.0)
    p.add_argument("--max_restarts", type=int, default=10)
    p.add_argument("argv", nargs=argparse.REMAINDER,
                   help="-- trainer command")
    args = p.parse_args(argv)
    cmd = args.argv
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        p.error("no trainer command given (pass it after --)")
    watch = args.watch or []
    if not watch:
        p.error("--watch is required (the trainer's metrics.jsonl)")
    return supervise(cmd, args.log, watch, args.stall_s,
                     args.startup_grace_s, args.poll_s, args.max_restarts)


if __name__ == "__main__":
    raise SystemExit(main())
