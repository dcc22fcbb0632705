"""The port's hand-written Hopper kernels (``csrc/``), each beside its
plain PyTorch version.  ROADMAP.md queue 2 lists the TPU kernels still to
port."""


def launch_counters():
    """Every kernel wrapper's launch counter as ``(wrapper, attribute)``,
    by kernel name: a wrapper adds one where it launches its kernel (the
    paged arms count their int8 pool launches apart).  Imported lazily:
    nothing here builds or loads a kernel."""
    from . import block_sparse_attention as bs
    from . import decode_attention as da
    from . import flash_attention as fa
    fns = {"flash_fwd": fa.flash_attention,
           "flash_bwd_dq": fa.flash_bwd_dq,
           "flash_bwd_dkv": fa.flash_bwd_dkv,
           "decode_attention": da.decode_attention,
           "decode_paged": da.decode_attention_paged,
           "decode_multi": da.decode_attention_multi,
           "decode_paged_multi": da.decode_attention_paged_multi,
           "block_sparse_fwd": bs.block_sparse_fwd,
           "block_sparse_bwd_dq": bs.block_sparse_bwd_dq,
           "block_sparse_bwd_dkv": bs.block_sparse_bwd_dkv}
    out = {name: (fn, "launches") for name, fn in fns.items()}
    for name in ("decode_paged", "decode_paged_multi"):
        out[name + "_int8"] = (fns[name], "launches_int8")
    return out
