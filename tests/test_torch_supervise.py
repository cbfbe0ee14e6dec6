"""The port's supervisor (fenerf_tpu_torch/apps/supervise.py) held to
fenerf_tpu/apps/supervise.py on tests/test_supervise.py's cases: fake
trainers that crash, stall or succeed on schedule (counted in their
attempts.txt) run under both supervisors side by side, each in its own
directory; the events, the attempts and the exit codes must agree, and
match what tests/test_supervise.py asserts of the JAX supervisor."""
import json
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

CASES = {
    "clean_exit": ("""
        open(metrics, "a").write('{"step": 1}\\n')
        print("done")
    """, ["launched", "done"], 0, "1", ()),
    "crash_then_resume": ("""
        open(metrics, "a").write('{"step": %d}\\n' % n)
        if n == 0:
            sys.exit(3)
        print("resumed fine")
    """, ["launched", "exit", "relaunching", "launched", "done"], 0, "2",
        ()),
    "stall_killed_and_resumed": ("""
        open(metrics, "a").write('{"step": %d}\\n' % n)
        if n == 0:
            time.sleep(600)
        print("resumed fine")
    """, ["launched", "stall_kill", "relaunching", "launched", "done"], 0,
        "2", ()),
    "gives_up_after_max_restarts": ("sys.exit(1)", None, 1, "4", ()),
    "startup_grace_protects_the_build": ("""
        time.sleep(4)
        open(metrics, "a").write('{"step": 0}\\n')
        print("built and progressed")
    """, ["launched", "done"], 0, "1",
        ("--startup_grace_s", "8", "--max_restarts", "0")),
}


def _fake_trainer(d: Path, body: str) -> Path:
    """tests/test_supervise.py::_fake_trainer: behaviour by launch count."""
    script = d / "fake_trainer.py"
    script.write_text(textwrap.dedent(f"""
        import os, sys, time
        d = {str(d)!r}
        cnt_f = os.path.join(d, "attempts.txt")
        n = int(open(cnt_f).read()) if os.path.exists(cnt_f) else 0
        open(cnt_f, "w").write(str(n + 1))
        metrics = os.path.join(d, "metrics.jsonl")
        {textwrap.indent(textwrap.dedent(body), ' ' * 8).strip()}
    """))
    return script


def _start(module: str, d: Path, script: Path, extra):
    opts = {"--stall_s": "2", "--startup_grace_s": "1", "--poll_s": "0.2",
            "--max_restarts": "3"}
    opts.update(dict(zip(extra[::2], extra[1::2])))
    return subprocess.Popen(
        [sys.executable, "-m", module, "--log", str(d / "run.log"),
         "--watch", str(d / "metrics.jsonl"),
         *[x for kv in opts.items() for x in kv],
         "--", sys.executable, "-S", str(script)],
        cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _events(d: Path):
    return [json.loads(x) for x in
            (d / "run.log.events.jsonl").read_text().splitlines()]


@pytest.mark.parametrize("case", list(CASES))
def test_supervisor_matches_jax(case, tmp_path):
    body, events, rc, attempts, extra = CASES[case]
    runs = {}
    for module in ("fenerf_tpu.apps.supervise",
                   "fenerf_tpu_torch.apps.supervise"):
        d = tmp_path / module.split(".")[0]
        d.mkdir()
        runs[module] = (d, _start(module, d, _fake_trainer(d, body), extra))
    seen = {}
    try:
        for module, (d, proc) in runs.items():
            out, _ = proc.communicate(timeout=120)
            ev = _events(d)
            seen[module] = ([e["event"] for e in ev], proc.returncode,
                            (d / "attempts.txt").read_text(),
                            [e.get("rc") for e in ev if e["event"] == "exit"])
            assert proc.returncode == rc, out
    finally:   # a failed assertion or a deadline leaves no child behind
        for _, proc in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    (jax_run, port_run) = seen.values()
    assert port_run == jax_run
    names, _, n, _ = port_run
    assert n == attempts
    if events is not None:
        assert names == events
    else:
        assert names[-1] == "giving_up" and names.count("launched") == 4
    d = runs["fenerf_tpu_torch.apps.supervise"][0]
    if case == "clean_exit":
        assert "done" in (d / "run.log.0").read_text()
    if case == "crash_then_resume":
        assert port_run[3] == [3]


def test_supervisor_needs_a_command_and_a_watch(capsys):
    from fenerf_tpu_torch.apps.supervise import main

    with pytest.raises(SystemExit):
        main(["--log", "x", "--watch", "m"])
    assert "no trainer command" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        main(["--log", "x", "--", "true"])
    assert "--watch is required" in capsys.readouterr().err
