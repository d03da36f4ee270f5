"""The port's counterparts of the examples (``examples/*_torch.py``), run
on the CPU at a small size, each in its own interpreter (see
``tests/torch_examples.py``); the language-model pair is in
``tests/test_torch_examples_lm.py``."""

import subprocess
import sys

from torch_examples import EXAMPLES, SCRIPTS, _env, run_example


def test_quickstart(tmp_path):
    out = run_example("quickstart_torch.py", ["--device", "cpu", "--n", "512"], tmp_path)
    assert "device=cpu" in out and "verify: 0 finding(s) (clean)" in out
    assert "raised=FaultError, fallbacks=0" in out
    err = float(out.split("plan-vs-dense max err:")[1].split()[0])
    assert err < 1e-4


def test_cg_solver(tmp_path):
    out = run_example("cg_solver_torch.py", ["--device", "cpu", "--n", "256"], tmp_path)
    assert "converged at iter" in out
    assert float(out.split("|Ax-b|_inf = ")[1].split()[0]) < 1e-3


def test_graph_analytics(tmp_path):
    out = run_example("graph_analytics_torch.py", ["--device", "cpu", "--n", "256"],
                      tmp_path)
    assert "bitwise vs dense: True" in out and "pagerank: converged=True" in out


def test_examples_refuse_a_missing_card(tmp_path):
    """Asked for the card (their default) where there is none, each
    example raises before any work; none falls back to the CPU."""
    code = (
        "import runpy, sys\n"
        "bad = []\n"
        f"for name in {list(SCRIPTS)!r}:\n"
        f"    path = {EXAMPLES!r} + '/' + name\n"
        "    sys.argv = [path]\n"
        "    try:\n"
        "        runpy.run_path(path, run_name='__main__')\n"
        "        bad.append(name)\n"
        "    except RuntimeError as err:\n"
        "        if 'no CUDA device' not in str(err):\n"
        "            bad.append(name)\n"
        "print(bad)\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=tmp_path, env=_env(tmp_path), timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip().endswith("[]"), out.stdout
