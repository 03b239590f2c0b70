"""Hand-written Hopper kernels of the port, each beside its plain version.

* ``kernels.morph_matmul`` — width-gated projection (``csrc/morph_matmul.cu``).
* ``kernels.fused_decode`` — one attention layer of one-token decode and of
  the speculative verify pass (``csrc/fused_decode.cu``,
  ``csrc/fused_verify.cu``, plus the morph_matmul kernel).
* ``kernels.ssd_scan`` — the Mamba2 SSD scan of the SSM prompt pass
  (``csrc/ssd_scan.cu``); ``kernels.ops.ssd_scan_bshn`` is its model-layout
  entry point.
* ``kernels.flash_attention`` — tiled causal / sliding-window GQA attention
  of the dense prompt pass under ``attn_impl="chunked"``
  (``csrc/flash_attention.cu``); ``kernels.ops.flash_attention_bshd`` is its
  model-layout entry point.
* ``kernels.flash_decode`` — single-token attention over a float or int8
  cache (``csrc/flash_decode.cu``): the encoder-decoder cross-attention
  decode (``layers.mha_decode(cross=True)``) on a card, and its own entry
  point, the reference's only caller.

Every Pallas kernel of the reference has its counterpart here, and the scan
has its backward (``csrc/ssd_scan_bwd.cu``, through ``ssd_scan.ScanFunction``).
The other kernels have no backward: their launches call ``refuse_grad``,
which raises under autograd rather than let a loss drop the gradients
through them. The submodules are not re-exported: a function named like
its module would shadow the module.

Each wrapper counts its launches (``launch_count()`` and friends). A
thread may count its own launches apart instead (``counted_apart``): the
online autoscaler's background warm-up does, so the wrappers' counters
hold the serving thread's launches alone.

Each kernel module has a ``cost`` beside its plain version: the (FLOPs,
bytes) of one launch from its shapes, dtypes, active widths and cache
lengths, the work its bound is reckoned from. A wrapper given meta tensors
inside an op trace (``launch.op_analysis.trace``) takes its meta route: it
records one launch with that cost, counts it (in the trace's tally, not
the wrapper's counters) and returns meta outputs of the kernel's shapes.
Outside a trace a meta tensor raises; a CUDA tensor always launches.
"""
import contextlib
import threading

_APART = threading.local()


def launch_counter(own: dict, kernel: str) -> dict:
    """The counter dict a launch of ``kernel`` on this thread adds to: the
    wrapper's ``own``, or, inside ``counted_apart(tally)``,
    ``tally[kernel]`` (made with ``own``'s keys at 0)."""
    tally = getattr(_APART, "tally", None)
    if tally is None:
        return own
    counts = tally.get(kernel)
    if counts is None:
        counts = tally[kernel] = dict.fromkeys(own, 0)
    return counts


@contextlib.contextmanager
def counted_apart(tally: dict):
    """Count this thread's kernel launches inside the block into ``tally``
    (kernel name -> that kernel's counters) instead of the wrappers' own
    counters."""
    prev = getattr(_APART, "tally", None)
    _APART.tally = tally
    try:
        yield tally
    finally:
        _APART.tally = prev


def on_card(t) -> bool:
    """True for a CUDA tensor, and for a meta tensor inside an op trace
    (which stands for one): where the model code takes a kernel route."""
    if t.device.type == "cuda":
        return True
    if t.is_meta:
        from repro_torch.launch.op_analysis import tracing

        return tracing()
    return False


def host_widths(a, full: int, batch: int) -> list:
    """An active-width operand as ``batch`` ints (``full`` for None or a
    meta tensor, whose values a trace cannot read)."""
    if a is None or getattr(a, "is_meta", False):
        return [full] * batch
    if hasattr(a, "dim"):
        a = a.tolist()
    if isinstance(a, (list, tuple)):
        return [int(v) for v in a]
    return [int(a)] * batch


def refuse_grad(kernel: str, *tensors) -> None:
    """Raise when grad mode is on and any of ``tensors`` requires grad:
    ``kernel``'s launch has no backward, so its outputs would carry no
    ``grad_fn`` and every gradient through it would be dropped without an
    error."""
    import torch

    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{kernel}: the CUDA kernel has no backward, and an input "
            f"requires grad; run it under torch.no_grad(), or train through "
            f"a path without this kernel")
