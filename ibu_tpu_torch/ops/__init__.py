"""Device operations: the 2-bit codec (CUDA kernels and plain torch
versions, fused record and single field), exact field sums, the record sort
and the barcode-grouped aggregations.

The package exports the thirteen names of :mod:`ibu_tpu.ops`'s ``__all__``
that have counterparts here. They resolve on first use (:func:`__getattr__`):
the numpy codec (:mod:`.codec`) loads no torch, and :mod:`.codec_cuda`,
:mod:`.stats` and :mod:`.u64`, which do, load only when one of their names is
asked for, so a host command that imports :mod:`.codec` stays free of torch.
The reference's other eleven names (``codec_pallas``, the ``lax_*`` and plane
forms, the u32 pair helpers) serve the TPU's layouts and have no counterpart.
"""

import importlib

#: name → the submodule that defines it (``None``: the name is the submodule)
_EXPORTS = {
    "codec": None,
    "stats": None,
    "u64": None,
    **dict.fromkeys(("decode_seqs", "encode_seqs", "np_pack", "np_unpack", "rows_to_seqs",
                     "seqs_to_rows"), "codec"),
    **dict.fromkeys(("decode_planes", "decode_records", "encode_planes", "encode_records"),
                    "codec_cuda"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    module = importlib.import_module(f"{__name__}.{_EXPORTS[name] or name}")
    value = module if _EXPORTS[name] is None else getattr(module, name)
    globals()[name] = value
    return value
