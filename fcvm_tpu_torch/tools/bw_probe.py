"""Device-memory bandwidth probe of one NVIDIA GPU: the port of
``tools/bw_probe.py``.

    python -m fcvm_tpu_torch.tools.bw_probe

It asks the card what the JAX probe asks the TPU, section by section:

1. elementwise pass: ``x * 1.0000001`` over (2^22, 128) float32, 2 GiB
   read and 2 GiB written (plain PyTorch);
2. the production einsum ``"eabj,ej->eab"`` over (131072, 10, 3, 30) blocks
   (plain PyTorch);
3. K0p (``soa_matvec``, tile 1024) at ne = 131072, beside K0
   (``block_matvec``) and the plain einsum, all on the same bytes;
4. Kbw (``bw_read``), a read of the 2 GiB array in 1 MiB chunks with k = 1,
   4, 8 copies in flight, beside a plain full read (``x.sum()``);
5. gathers: rows of width 3 and 12 at 1.18 M indices, and the batched
   small-domain gather (``torch.gather``, the JAX ``take_along_axis``).

Every time is the median of ``RUNS`` CUDA-event timings after a warm-up.
Each bandwidth is also given as a share of the highest read rate the probe
measured itself (the best Kbw k or ``x.sum()``) and of the published 3.35
TB/s of an H100 SXM.  The card's ``nvidia-smi`` name and power limit come
first.  A section that fails raises; without a CUDA device the probe exits
non-zero.  Kbw fails its section when it takes less than
``MIN_FULL_READ_SHARE`` of the time of ``x.sum()`` on the same array: its
result depends only on the chunk heads, so a faster Kbw has not read every
byte.
"""

from __future__ import annotations

import subprocess
import sys

import numpy as np
import torch

from fcvm_tpu_torch.ops import kernels

PUBLISHED_GBS = 3350.0  # H100 SXM HBM3, NVIDIA's data sheet
RUNS = 20
ROWS = 2**22  # (ROWS, 128) float32 = 2 GiB
NE = 131_072
TILE = 1024
CHUNK_ROWS = 2048  # 1 MiB chunks
KS = (1, 4, 8)
# Kbw's result depends only on the chunk heads, so its time is what shows
# that it moved every byte: a kernel that copies all of x cannot beat a
# plain full read of it by more than run-to-run noise
MIN_FULL_READ_SHARE = 0.9
NN, NIDX = 166_000, 1_180_000  # gather: table rows, indices
NEL = 118_000  # batched gather: (NEL, 24, 3) -> (NEL, 10, 3)


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, runs: int = RUNS) -> float:
    """Median of ``runs`` CUDA-event timings of one call each, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def run(seed: int = 0, report=print) -> dict:
    """Run every section on ``cuda:0``; return ``{name: {"ms", "gbs", ...}}``
    (GB/s of the bytes each section reads, for the elementwise pass read plus
    written) and, under ``"best_read_gbs"``, the highest read rate measured.
    Kbw's rows carry ``launches``, the kernel launches of their section."""
    if not torch.cuda.is_available():
        raise RuntimeError("the bandwidth probe needs a CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = {}

    def row(name, ms, nbytes, **extra):
        out[name] = dict(ms=ms, gbs=nbytes / ms / 1e6, **extra)
        report(f"{name}: {ms:.4f} ms -> {nbytes / ms / 1e6:.0f} GB/s")

    report(card())
    report(f"--- 1. elementwise (2 GiB read + 2 GiB write per pass), median of {RUNS}")
    x = torch.rand((ROWS, 128), generator=gen, device=dev)
    nbytes = x.numel() * x.element_size()
    row("elementwise x * 1.0000001", cuda_ms(lambda: x * 1.0000001), 2 * nbytes)

    report(f"--- 2. production einsum (ne = {NE}, (ne, 10, 3, 30) blocks)")
    esm4 = torch.randn((NE, 10, 3, 30), generator=gen, device=dev)
    ue = torch.randn((NE, 30), generator=gen, device=dev)
    row('einsum "eabj,ej->eab"', cuda_ms(lambda: torch.einsum("eabj,ej->eab", esm4, ue)),
        esm4.numel() * 4)

    report(f"--- 3. K0p soa_matvec (tile {TILE}) beside K0 and the plain einsum, "
           "same (30, 30, ne) bytes")
    esm_t = esm4.reshape(NE, 30, 30).permute(1, 2, 0).contiguous()
    ue_t = ue.T.contiguous()
    del esm4, ue
    blk = esm_t.numel() * 4
    before = kernels.soa_matvec.launches
    row("K0p soa_matvec", cuda_ms(lambda: kernels.soa_matvec(esm_t, ue_t, TILE)), blk,
        launches=kernels.soa_matvec.launches - before)
    row("K0 block_matvec", cuda_ms(lambda: kernels.block_matvec(esm_t, ue_t)), blk)
    row("plain einsum (soa_matvec_ref)",
        cuda_ms(lambda: kernels.soa_matvec_ref(esm_t, ue_t)), blk)
    del esm_t, ue_t

    report(f"--- 4. Kbw bw_read, 2 GiB in {CHUNK_ROWS * 512 // 2**20} MiB chunks, "
           "k copies in flight per block")
    for k in KS:
        before = kernels.bw_read.launches
        row(f"Kbw bw_read k={k}", cuda_ms(lambda: kernels.bw_read(x, k, CHUNK_ROWS)), nbytes,
            launches=kernels.bw_read.launches - before)
    row("plain full read x.sum()", cuda_ms(lambda: x.sum()), nbytes)
    full_ms = out["plain full read x.sum()"]["ms"]
    for k in KS:
        share = out[f"Kbw bw_read k={k}"]["ms"] / full_ms
        report(f"Kbw k={k} time / x.sum() time: {share:.3f} (at least {MIN_FULL_READ_SHARE})")
        if share < MIN_FULL_READ_SHARE:
            raise RuntimeError(
                f"Kbw (k={k}) read 2 GiB in {share:.3f} of a full read's time: it "
                "cannot have copied every byte")
    ms = cuda_ms(lambda: kernels.bw_read_ref(x, CHUNK_ROWS))
    out["plain bw_read_ref"] = dict(ms=ms, gbs=None)
    report(f"plain bw_read_ref (reads {ROWS // CHUNK_ROWS} values): {ms:.4f} ms")
    del x

    report(f"--- 5. gathers, {NIDX} indices into {NN} rows")
    rng = np.random.default_rng(seed)
    base = np.repeat(np.arange(NIDX // 8) * (NN * 8 // NIDX), 8)
    idx = torch.as_tensor((base + rng.integers(0, 32, NIDX)).clip(0, NN - 1), device=dev)
    for width in (3, 12):
        u = torch.rand((NN, width), generator=gen, device=dev)
        row(f"gather width {width * 4} B", cuda_ms(lambda: u[idx]), NIDX * width * 4)
    buf = torch.rand((NEL, 24, 3), generator=gen, device=dev)
    lidx = torch.as_tensor(rng.integers(0, 24, (NEL, 10, 1)), device=dev).expand(NEL, 10, 3)
    row("batched gather (118k, 24 -> 10, 3)", cuda_ms(lambda: torch.gather(buf, 1, lidx)),
        NEL * 10 * 3 * 4)

    best = max(out[f"Kbw bw_read k={k}"]["gbs"] for k in KS)
    best = max(best, out["plain full read x.sum()"]["gbs"])
    out["best_read_gbs"] = best
    report(f"--- shares of the best measured read, {best:.0f} GB/s, and of the "
           f"published {PUBLISHED_GBS:.0f} GB/s")
    for name, r in out.items():
        if isinstance(r, dict) and r.get("gbs"):
            report(f"{name}: {100 * r['gbs'] / best:.0f}% of best read, "
                   f"{100 * r['gbs'] / PUBLISHED_GBS:.0f}% of published")
    return out


def main():
    if not torch.cuda.is_available():
        raise SystemExit("FAILED: torch.cuda.is_available() is false; the probe "
                         "measures an NVIDIA GPU")
    info = kernels.build()
    print(f"kernels built and loaded in {info.seconds:.2f} s", flush=True)
    run(report=lambda s: print(s, flush=True))


if __name__ == "__main__":
    sys.exit(main())
