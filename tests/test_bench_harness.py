"""bench.py record tests.

The harness must re-emit the full record line after EVERY phase, emit on
SIGTERM/SIGINT, skip phases whose estimated cost exceeds the remaining
wall budget — so the consumer's last parseable line always carries
everything measured so far — and exit non-zero when any phase failed or
the device is not a GPU. Every record names the device it ran on.
"""

import importlib.util
import json
import os
import signal
import subprocess
import sys
import textwrap

import pytest

_BENCH = os.path.join(os.path.dirname(__file__), os.pardir, "bench.py")


@pytest.fixture()
def bench():
    spec = importlib.util.spec_from_file_location("bench_mod", _BENCH)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class FakeJaxRuntimeError(Exception):
    pass


FakeJaxRuntimeError.__name__ = "JaxRuntimeError"


def test_terminal_failure_still_emits_parseable_json(bench, capsys):
    """A phase that fails is recorded in `errors`, other phases' fields
    survive, and emit() prints one parseable JSON line."""
    rec = bench.Recorder()
    rec.detail["chap12_mrays_per_s"] = 92.1

    def always_fails():
        raise FakeJaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")

    assert rec.phase("train_8spp", always_fails) is None
    assert "train_8spp" in rec.errors
    capsys.readouterr()  # drop the traceback logging

    rec.emit()
    parsed = json.loads(capsys.readouterr().out.strip())
    assert parsed["detail"]["chap12_mrays_per_s"] == 92.1
    assert "RESOURCE_EXHAUSTED" in parsed["errors"]["train_8spp"]


def test_emit_with_no_headline_is_still_parseable(bench, capsys):
    """Even a fully failed run emits JSON, never a bare traceback exit."""
    rec = bench.Recorder()
    rec.errors["scene_build"] = "JaxRuntimeError: boom"
    rec.emit()
    parsed = json.loads(capsys.readouterr().out.strip())
    assert parsed["detail"]["phase_walls"] == {}
    assert parsed["errors"]["scene_build"].startswith("JaxRuntimeError")


@pytest.mark.parametrize("fails", [False, True])
def test_failed_phase_makes_exit_nonzero(bench, capsys, fails):
    rec = bench.Recorder()

    def phase():
        if fails:
            raise ValueError("broken")
        return 1

    rec.phase("forward_chap12", phase)
    assert rec.exit_code() == (1 if fails else 0)


def test_bench_refuses_non_gpu_and_names_device(tmp_path):
    """Without the CPU test hook, bench.py on a CPU-only JAX prints one
    record naming the device and exits non-zero before any phase."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path / "jc"))
    env.pop("RRT_BENCH_FORCE_CPU", None)
    out = subprocess.run([sys.executable, _BENCH], capture_output=True,
                         text=True, timeout=300, cwd=str(tmp_path),
                         env=env)
    assert out.returncode == 2, out.stderr[-2000:]
    parsed = _last_json_line(out.stdout)
    dev = parsed["device"]
    assert dev["platform"] == "cpu" and dev["count"] >= 1
    assert dev["kind"] and "nvidia_smi" in dev
    assert "no GPU" in parsed["errors"]["device"]
    assert parsed["detail"]["phase_walls"] == {}


def test_terminal_failure_logs_real_traceback(bench, capsys):
    """The stderr diagnostic must carry the actual traceback, not
    'NoneType: None' (format_exc() must be captured inside the except
    block — the exception state is cleared when it exits)."""
    rec = bench.Recorder()

    def broken():
        raise ValueError("the real diagnostic")

    rec.phase("train_8spp", broken)
    err = capsys.readouterr().err
    assert "the real diagnostic" in err
    assert "NoneType: None" not in err


def _last_json_line(out: str):
    """The consumer contract: the last parseable line of output wins."""
    parsed = None
    for line in out.splitlines():
        try:
            parsed = json.loads(line)
        except ValueError:
            continue
    return parsed


def test_record_reemitted_after_every_phase(bench, capsys):
    """A SIGKILL at any point must cost only the unfinished phase, which
    requires the full record line on stdout after EVERY phase."""
    rec = bench.Recorder(wall_budget_s=1e9)

    def p1():
        rec.detail["fwd_mrays_per_s"] = 92.1

    def p2():
        rec.detail["cornell_mrays_per_s"] = 170.8

    rec.phase("forward_chap12", p1)
    rec.phase("forward_cornell", p2)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.strip().startswith("{")]
    assert len(lines) == 2
    first, second = json.loads(lines[0]), json.loads(lines[1])
    assert first["detail"]["fwd_mrays_per_s"] == 92.1
    assert "cornell_mrays_per_s" not in first["detail"]
    assert second["detail"]["cornell_mrays_per_s"] == 170.8
    assert second["detail"]["fwd_mrays_per_s"] == 92.1  # fields survive
    assert second["detail"]["phase_walls"].keys() == {
        "forward_chap12", "forward_cornell"}


def test_budget_skip_records_and_emits(bench, capsys):
    """A phase whose estimate exceeds the remaining wall budget is
    skipped (recorded in detail.skipped), never started, and the record
    line is re-emitted so the skip itself is visible."""
    rec = bench.Recorder(wall_budget_s=0.0)
    ran = []
    assert rec.phase("north_star_500spp", lambda: ran.append(1),
                     est_s=120) is None
    assert ran == []
    assert rec.skipped == ["north_star_500spp"]
    parsed = _last_json_line(capsys.readouterr().out)
    assert parsed["detail"]["skipped"] == ["north_star_500spp"]
    assert "north_star_500spp" not in parsed["detail"]["phase_walls"]
    # est_s=0 phases always run.
    assert rec.phase("forward_chap12", lambda: 7) == 7


_BENCH_DIR = os.path.dirname(_BENCH)


def test_sigterm_emits_record_and_exits(tmp_path):
    """The SIGTERM handler (timeout(1) sends SIGTERM first) must emit the
    record with everything measured so far and exit non-zero: a cut run
    is a failed run."""
    script = textwrap.dedent("""
        import importlib.util, os, signal, sys
        spec = importlib.util.spec_from_file_location("bench_mod", %r)
        bench = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(bench)
        rec = bench.Recorder()
        bench.install_signal_handlers(rec)
        rec.detail["fwd_mrays_per_s"] = 92.1
        rec.current = "north_star_500spp"
        os.kill(os.getpid(), signal.SIGTERM)
        sys.exit(3)  # unreachable: the handler exits
    """ % os.path.join(_BENCH_DIR, "bench.py"))
    p = tmp_path / "kill_self.py"
    p.write_text(script)
    out = subprocess.run([sys.executable, str(p)], capture_output=True,
                         text=True, timeout=120, cwd=_BENCH_DIR)
    assert out.returncode == 1, out.stderr
    parsed = _last_json_line(out.stdout)
    assert parsed is not None, out.stdout
    assert parsed["detail"]["fwd_mrays_per_s"] == 92.1
    assert "SIGTERM" in parsed["errors"]["signal"]
    assert "north_star_500spp" in parsed["errors"]["signal"]


@pytest.mark.slow
def test_bench_under_timeout_prints_parseable_record():
    """`timeout 30 python bench.py` must leave a parseable JSON line with
    partial fields on stdout. Forced to the CPU (the test hook): the
    full-size phases cannot finish there, so timeout's SIGTERM arrives
    mid-phase and the handler emits the record."""
    env = dict(os.environ, RRT_BENCH_FORCE_CPU="1",
               RRT_BENCH_WALL_S="20")
    out = subprocess.run(
        ["timeout", "30", sys.executable,
         os.path.join(_BENCH_DIR, "bench.py")],
        capture_output=True, text=True, timeout=180, cwd=_BENCH_DIR,
        env=env)
    assert out.returncode != 0, (out.returncode, out.stderr[-2000:])
    parsed = _last_json_line(out.stdout)
    assert parsed is not None, (out.stdout, out.stderr[-2000:])
    assert parsed["device"]["platform"] == "cpu"
    assert "phase_walls" in parsed["detail"]
