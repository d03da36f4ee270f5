"""The language-model examples of the port (``examples/serve_lm_torch.py``,
``examples/train_lm_torch.py``) on the CPU at a small size, each in its
own interpreter (see ``tests/torch_examples.py``)."""

from torch_examples import run_example


def test_serve_lm(tmp_path):
    out = run_example("serve_lm_torch.py", ["--device", "cpu"], tmp_path)
    assert out.count("first completion:") == 2
    assert "scheduled-stream utilization per matrix" in out


def test_train_lm_a_few_steps(tmp_path):
    out = run_example("train_lm_torch.py", ["--device", "cpu", "--steps", "3", "--layers",
                                            "1", "--d-model", "64", "--seq-len", "16"],
                      tmp_path)
    assert "3 steps on cpu" in out and "GUST handoff" in out
    first, last = (float(x) for x in out.split("loss: ")[1].split()[0:3:2])
    assert last < first
