"""The port's policy linter (``repro_torch.analysis.lint``, GUST-L01 and
L03..L07): the port lints clean, the linter reads only ``repro_torch/``,
each adopted rule fires on a small tree, and the allowlist silences
exactly the site it names (as ``tests/test_analysis.py`` holds the
reference's linter)."""

import os
import subprocess
import sys

from repro_torch.analysis import lint as L

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _lint_tmp(tree, tmp_path, allowlist=os.devnull):
    for rel, src in tree.items():
        path = tmp_path / rel
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(src)
    return L.lint_sources(str(tmp_path), allowlist=allowlist)


def test_port_lints_clean():
    assert L.lint_sources() == []


def test_allowlist_names_exactly_the_sites_the_rules_find():
    """No stale entry: without the allowlist the findings are exactly its
    sites (the decision points of L03 and the two L06 lookups that key no
    artifact)."""
    found = {(f.rule, f.site) for f in L.lint_sources(allowlist=os.devnull)}
    assert found == L.load_allowlist()
    assert {rule for rule, _ in found} == {"GUST-L03", "GUST-L06"}
    assert ("GUST-L06", "repro_torch/kernels/gust_spmv.py::spread_launch_plan") in found
    assert ("GUST-L06", "repro_torch/distributed/collectives.py::_ring_hop") in found


def test_lint_reads_only_the_package(monkeypatch, tmp_path):
    opened = []

    def recording_open(path, *args, **kwargs):
        opened.append(os.path.abspath(path))
        return open(path, *args, **kwargs)

    monkeypatch.setattr(L, "open", recording_open, raising=False)
    assert L.lint_sources() == []
    sources = [p for p in opened if p.endswith(".py")]
    assert sources and all(
        p.startswith(os.path.join(ROOT, "repro_torch") + os.sep) for p in sources)
    assert len(sources) == sum(
        f.endswith(".py") for _, _, files in os.walk(os.path.join(ROOT, "repro_torch"))
        for f in files)
    # files beside the package are never read, whatever they hold
    bad = "import jax\nimport numpy as np\nnp.savez('a.npz')\n"
    tree = {"src/repro/x.py": bad, "tests/test_x.py": bad, "examples/x.py": bad,
            "repro_torch/ok.py": "x = 1\n"}
    assert _lint_tmp(tree, tmp_path) == []


def test_lint_rules_fire(tmp_path):
    findings = _lint_tmp({
        "repro_torch/__init__.py": "import torch\n",
        "repro_torch/core/__init__.py": "from .formats import COOMatrix\n",
        "repro_torch/core/x.py": (
            "import numpy as np\n"
            "def shiny_new_api():\n"
            "    import jax\n"
            "    np.savez('a.npz')\n"
            "    spmv(None, None)\n"
            "    resolve_layout(None, 8, None)\n"
            "_cache = {}\n"
            "def _lookup(backend):\n"
            "    return _cache.get((1, backend))\n"
        ),
    }, tmp_path)
    by_rule = {}
    for f in findings:
        by_rule.setdefault(f.rule, []).append(f)
    assert sorted(by_rule) == ["GUST-L01", "GUST-L03", "GUST-L04", "GUST-L05", "GUST-L06"]
    # L01 three times: torch eager in a lazy package, a relative import in
    # another, jax inside a function of a plain module
    assert sorted(f.path for f in by_rule["GUST-L01"]) == [
        "repro_torch/__init__.py", "repro_torch/core/__init__.py", "repro_torch/core/x.py"]
    # GUST-L02 is not adopted: a public free function is no finding
    assert "GUST-L02" not in L.LINT_RULES


def test_lint_l01_lazy_packages(tmp_path):
    lazy = (
        "from typing import TYPE_CHECKING\n"
        "_EXPORTS = {'plan': 'repro_torch.core.plan'}\n"
        "def __getattr__(name):\n"
        "    import importlib\n"
        "    return getattr(importlib.import_module(_EXPORTS[name]), name)\n"
        "if TYPE_CHECKING:\n"
        "    import torch\n"
        "    from repro_torch.core.plan import plan\n"
    )
    assert _lint_tmp({"repro_torch/analysis/__init__.py": lazy}, tmp_path) == []
    # torch at module scope of a plain module is fine; jax nowhere, not even
    # for type checkers
    plain = "import torch\nfrom typing import TYPE_CHECKING\nif TYPE_CHECKING:\n    import repro\n"
    found = _lint_tmp({"repro_torch/models/y.py": plain}, tmp_path / "b")
    assert [(f.rule, f.line) for f in found] == [("GUST-L01", 4)]


def test_lint_l07_bare_except_pass_on_serving_path(tmp_path):
    swallow = (
        "def _risky():\n"
        "    try:\n"
        "        pass\n"
        "    except Exception:\n"
        "        pass\n"
    )
    findings = _lint_tmp({"repro_torch/serving/loop.py": swallow}, tmp_path)
    assert [f.rule for f in findings] == ["GUST-L07"]
    assert findings[0].qualname == "_risky"
    assert _lint_tmp({"repro_torch/graph/x.py": swallow}, tmp_path / "b") == []
    handled = swallow.replace("except Exception:\n        pass",
                              "except Exception as err:\n        record(err)")
    assert _lint_tmp({"repro_torch/serving/ok.py": handled}, tmp_path / "c") == []
    narrow = swallow.replace("except Exception:", "except KeyError:")
    assert _lint_tmp({"repro_torch/serving/nrw.py": narrow}, tmp_path / "d") == []


def test_lint_allowlist_silences_exact_site(tmp_path):
    (tmp_path / "allow.txt").write_text(
        "GUST-L05  repro_torch/core/x.py::shiny  # test entry\n")
    src = ("import numpy as np\n"
           "def shiny():\n    np.savez('a')\n\n\n"
           "def other():\n    np.savez('b')\n")
    findings = _lint_tmp({"repro_torch/core/x.py": src}, tmp_path,
                         allowlist=str(tmp_path / "allow.txt"))
    assert [(f.rule, f.qualname) for f in findings] == [("GUST-L05", "other")]


def test_lint_cli_exits_zero_on_the_tree():
    out = subprocess.run([sys.executable, "-m", "repro_torch.analysis", "lint"],
                         capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "lint: 0 finding(s)" in out.stdout
