"""Times one SUM all-reduce between two ranks that share one card, over gloo.

Phase 17 of ``chip_smoke.py`` runs tensor parallelism as two processes on
one H100, where gloo reduces CUDA tensors through the host.  This probe
times the all-reduce alone, at two sizes (a served step's hidden states,
``[2, 32, 4096]`` bf16, and a block's logits over LLaDA-8B's padded vocab,
``[2, 32, 126720]`` bf16), four ways: gloo on the CUDA tensor; staged
through a pinned host buffer by hand; staged through ``.cpu()``; and each
of the first two after ten 64 x 4096 x 4096 bf16 matmuls on both ranks
(the other rank's work on the shared card).  Prints one JSON line a rank:
ms per all-reduce, the mean of 50 after 5 warm-up calls.

    python3 tools/torch_allreduce_probe.py   # one H100
"""
import json
import sys
import tempfile
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

SHAPES = ((2, 32, 4096), (2, 32, 126720))
MODES = ("cuda", "host_pinned", "host", "cuda+work", "host_pinned+work")


def probe(mesh) -> dict:
    from repro_torch.sharding.comm import TPGroup

    group = TPGroup.from_mesh(mesh).group
    w = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    h = torch.randn(64, 4096, device="cuda", dtype=torch.bfloat16)
    out = {}
    for shape in SHAPES:
        x = torch.randn(*shape, device="cuda", dtype=torch.bfloat16)
        pinned = torch.empty(shape, dtype=torch.bfloat16, pin_memory=True)
        for mode in MODES:
            def reduce():
                if mode.startswith("cuda"):
                    dist.all_reduce(x, group=group)
                elif mode.startswith("host_pinned"):
                    pinned.copy_(x)
                    dist.all_reduce(pinned, group=group)
                    x.copy_(pinned, non_blocking=True)
                else:
                    y = x.cpu()
                    dist.all_reduce(y, group=group)
                    x.copy_(y)

            def once():
                if mode.endswith("+work"):
                    for _ in range(10):
                        h @ w
                reduce()
            for _ in range(5):
                once()
            torch.cuda.synchronize()
            dist.barrier(group=group)
            t0 = time.perf_counter()
            for _ in range(50):
                once()
            torch.cuda.synchronize()
            out[f"{shape[-1]} {mode}"] = (time.perf_counter() - t0) / 50 * 1e3
    t0 = time.perf_counter()
    for _ in range(50):
        for _ in range(10):
            h @ w
    torch.cuda.synchronize()
    out["work alone"] = (time.perf_counter() - t0) / 50 * 1e3
    return out


def main() -> None:
    from repro_torch.launch.tp import spawn

    print(torch.cuda.get_device_name(0), torch.__version__)
    with tempfile.TemporaryDirectory() as d:
        for rank, res in enumerate(spawn(probe, 2, workdir=d)):
            print(json.dumps({"rank": rank, **{k: round(v, 3) for k, v in res.items()}}))


if __name__ == "__main__":
    main()
