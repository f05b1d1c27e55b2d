"""Which collectives gloo takes on CUDA tensors, on one card.

    python3 benchmarks/torch_gloo_cuda_probe.py

Two ranks spawned on ``cuda:0`` (NCCL refuses two ranks on one card) try
``all_gather_into_tensor``, ``all_reduce`` and ``reduce_scatter_tensor``
on CUDA tensors in float32 and bfloat16, and record, inside a
``TorchDispatchMode``, the ``c10d`` ops of an autograd function whose
backward reduce-scatters (falling back to host memory only if gloo
refuses). Prints the versions, the seconds from spawn to exit, and each
rank's outcome per collective. ``launch/vfl_step.py`` sends CUDA payloads
to gloo as they are because every one is taken (torch 2.11.0+cu128).
"""

import datetime
import json
import sys
import tempfile
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode


class Rec(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("c10d"):
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


class G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = torch.empty(2 * x.shape[0], *x.shape[1:], device=x.device, dtype=x.dtype)
        dist.all_gather_into_tensor(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g):
        out = torch.empty(g.shape[0] // 2, *g.shape[1:], device=g.device, dtype=g.dtype)
        try:
            dist.reduce_scatter_tensor(out, g.contiguous())
        except Exception:
            gc = g.cpu().contiguous()
            oc = out.cpu()
            dist.reduce_scatter_tensor(oc, gc)
            out = oc.to(g.device)
        return out


def child(rank, path, res):
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method="file://" + path, rank=rank, world_size=2,
        timeout=datetime.timedelta(seconds=30),
    )
    out = {}
    for dt in (torch.float32, torch.bfloat16):
        x = torch.full((4, 2), float(rank + 1), device="cuda", dtype=dt)
        for name, fn in (
            ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(torch.empty(8, 2, device="cuda", dtype=dt), x)),
            ("all_reduce", lambda: dist.all_reduce(x.clone())),
            ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(torch.empty(2, 2, device="cuda", dtype=dt), torch.ones(4, 2, device="cuda", dtype=dt))),
        ):
            try:
                t0 = time.time()
                fn()
                torch.cuda.synchronize()
                out[f"{name}/{dt}"] = f"ok {1e3 * (time.time() - t0):.2f} ms"
            except Exception as e:
                out[f"{name}/{dt}"] = "ERR " + str(e).splitlines()[0][:200]
            dist.barrier()
    w = torch.randn(3, 4, device="cuda", requires_grad=True)
    rec = Rec()
    with rec:
        y = G.apply(torch.randn(5, 3, device="cuda") @ w)
        torch.autograd.grad(y.square().sum(), [w])
    out["dispatch_ops_with_backward"] = rec.ops
    with open(res + f".{rank}", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


if __name__ == "__main__":
    print(sys.version, torch.__version__, torch.version.cuda, torch.cuda.get_device_name(0))
    d = tempfile.mkdtemp()
    t0 = time.time()
    mp.start_processes(child, args=(d + "/rdv", d + "/res"), nprocs=2, start_method="spawn")
    print("spawn+run", time.time() - t0)
    for r in range(2):
        with open(d + f"/res.{r}") as f:
            print(r, json.dumps(json.load(f), indent=1))
