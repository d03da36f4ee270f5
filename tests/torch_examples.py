"""Runs the port's ``examples/*_torch.py`` scripts for the CPU tests.

Each runs in its own interpreter with its own ``timeout=``, from
``tmp_path`` (its working and temporary directory), with only the
repository root on ``PYTHONPATH`` and one CPU thread, and must leave
``jax`` and ``repro`` out of ``sys.modules``."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
SCRIPTS = ("quickstart_torch.py", "cg_solver_torch.py", "graph_analytics_torch.py",
           "serve_lm_torch.py", "train_lm_torch.py")

#: Runs a script as ``__main__`` with the given arguments, then prints the
#: foreign modules it loaded as the last line.
_RUNNER = (
    "import json, runpy, sys\n"
    "path, argv = sys.argv[1], sys.argv[2:]\n"
    "sys.argv = [path, *argv]\n"
    "try:\n"
    "    runpy.run_path(path, run_name='__main__')\n"
    "finally:\n"
    "    print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'jaxlib', 'repro'))))\n"
)


def _env(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=ROOT, TMPDIR=str(tmp_path), HOME=str(tmp_path),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return env


def run_example(script, args, tmp_path, timeout=120):
    """Run ``examples/<script> <args>``; return its standard output, less
    the runner's last line.  Fails on a nonzero exit or a foreign import."""
    before = sorted(os.listdir(EXAMPLES))
    out = subprocess.run(
        [sys.executable, "-c", _RUNNER, os.path.join(EXAMPLES, script), *args],
        capture_output=True, text=True, cwd=tmp_path, env=_env(tmp_path),
        timeout=timeout)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    lines = out.stdout.rstrip("\n").split("\n")
    assert json.loads(lines[-1]) == [], f"{script} imported {lines[-1]}"
    assert sorted(os.listdir(EXAMPLES)) == before, f"{script} wrote into examples/"
    return "\n".join(lines[:-1])
