"""What the BT4 cell's net metrics share: the FLOPs of the leaf
evaluations that the traced slice counted (the program's counters
``net.tokens`` and ``net.boards``, times ``work_bt4``'s FLOPs per token
and per board, which the cell's counts carry), and the device time of
kernels picked by name.

The name fragments are those of the H100's kernels.  GEMMs: cuBLAS's and
cuBLASLt's (on the H100 with PyTorch 2.11 and CUDA 12.8 the trunk's bf16
products run as ``nvjet_tst_*``, the float32 heads as ``sgemm_largek_*``,
``sm80_xmma_gemm_f32f32_*`` and ``cutlass_80_simt_sgemm_*``, small bf16
ones as ``cutlass_75_tensorop_bf16_s1688gemm_*``; also ``gemv*`` and
``splitKreduce_kernel``).  Attention: the kernels that
``F.scaled_dot_product_attention`` launches (there cuDNN's
``cudnn_generated_fort_native_sdpa_sm90_flash_fprop_*``; elsewhere the
memory-efficient ``fmha_cutlassF_*`` with ``AttentionKernel``, or flash
``flash_fwd_*``).  A name that holds an attention fragment is attention,
whatever else it holds."""

from __future__ import annotations

from h100bench.metrics import _counters

GEMM = ("gemm", "nvjet", "gemv", "splitKreduce")
ATTENTION = ("fmha", "AttentionKernel", "flash_fwd", "sdpa")


def is_attention(name: str) -> bool:
    return any(f in name for f in ATTENTION)


def is_gemm(name: str) -> bool:
    return not is_attention(name) and any(f in name for f in GEMM)


def busy_share(data, pick) -> float | None:
    """Device seconds of the slice's kernels whose name ``pick`` accepts,
    over the slice's busy time."""
    t = data["trace"]
    if not t["busy_s"] or not t["kernel_s"]:
        return None
    return sum(s for name, (s, _) in t["kernel_s"].items()
               if pick(name)) / t["busy_s"]


def slice_flops(data) -> float | None:
    """FLOPs of the slice's leaf evaluations, or None where the program
    counted none."""
    c, counts = _counters.counters(data), data["counts"]
    tokens, boards = c.get("net.tokens"), c.get("net.boards")
    if not tokens or not boards or "net_token_flops" not in counts:
        return None
    return (tokens * counts["net_token_flops"]
            + boards * counts["net_board_flops"])
