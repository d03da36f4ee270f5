"""Which collectives the gloo backend takes on CUDA tensors, in the
installed torch: each op in its own pair of processes on ``cuda:0`` (an
op gloo refuses may raise, hang or crash its process), each process with
a 60 s timeout and a 30 s group timeout, its result checked against the
sum, the gather or the scatter it should give.  Prints one JSON line: per
op each rank's exit code and last line (``RESULT {"ok": ...}`` when it
ran).  ``distributed/collectives.HOST_STAGED`` records the answer for the
torch the port runs on (torch 2.11.0+cu128 on an H100: every op here but
``send_recv`` takes CUDA tensors; ``send_recv`` crashed its ranks, "Bad
address").

    python -m repro_torch.distributed.gloo_probe
"""

import datetime
import json
import subprocess
import sys
import tempfile

OPS = ("all_reduce", "all_gather", "reduce_scatter", "broadcast", "send_recv",
       "all_gather_into_tensor", "reduce_scatter_tensor")
WORLD = 2


def rank_main(op: str, rank: int, rdv: str) -> None:
    """One rank: ``op`` on a CUDA tensor, then ``RESULT {"ok": ...}``."""
    import torch
    import torch.distributed as dist

    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{rdv}/rdv", rank=rank,
                            world_size=WORLD, timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda:0")
    mine = [torch.arange(8, dtype=torch.float32) + 10 * r for r in range(WORLD)]
    x = mine[rank].to(dev)
    total = sum(mine)
    if op == "all_reduce":
        y = x.clone()
        dist.all_reduce(y)
        ok = torch.equal(y.cpu(), total)
    elif op == "all_gather":
        outs = [torch.empty_like(x) for _ in range(WORLD)]
        dist.all_gather(outs, x)
        ok = all(torch.equal(o.cpu(), m) for o, m in zip(outs, mine))
    elif op == "reduce_scatter":
        out = torch.empty(8 // WORLD, device=dev)
        dist.reduce_scatter(out, list(x.clone().chunk(WORLD)))
        ok = torch.equal(out.cpu(), total.chunk(WORLD)[rank])
    elif op == "broadcast":
        y = x.clone()
        dist.broadcast(y, 0)
        ok = torch.equal(y.cpu(), mine[0])
    elif op == "send_recv":
        out = torch.empty_like(x)
        ops = [dist.P2POp(dist.isend, x, (rank + 1) % WORLD),
               dist.P2POp(dist.irecv, out, (rank - 1) % WORLD)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        ok = torch.equal(out.cpu(), mine[(rank - 1) % WORLD])
    elif op == "all_gather_into_tensor":
        out = torch.empty(8 * WORLD, device=dev)
        dist.all_gather_into_tensor(out, x)
        ok = torch.equal(out.cpu(), torch.cat(mine))
    else:  # reduce_scatter_tensor
        out = torch.empty(8 // WORLD, device=dev)
        dist.reduce_scatter_tensor(out, x.clone())
        ok = torch.equal(out.cpu(), total.chunk(WORLD)[rank])
    torch.cuda.synchronize()
    dist.destroy_process_group()
    print("RESULT", json.dumps({"ok": bool(ok)}))


def main() -> int:
    import torch

    res = {"torch": torch.__version__, "cuda": torch.version.cuda}
    for op in OPS:
        with tempfile.TemporaryDirectory() as rdv:
            procs = [subprocess.Popen([sys.executable, "-m", __spec__.name, op, str(r), rdv],
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True) for r in range(WORLD)]
            rows = []
            for p in procs:
                try:
                    text, _ = p.communicate(timeout=60)
                except subprocess.TimeoutExpired:
                    p.kill()
                    text = "TIMEOUT " + p.communicate()[0]
                lines = text.strip().splitlines()
                rows.append({"rc": p.returncode, "tail": lines[-1][:200] if lines else ""})
            res[op] = rows
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1:
        rank_main(sys.argv[1], int(sys.argv[2]), sys.argv[3])
    else:
        sys.exit(main())
