"""allwave_tpu_torch — the PyTorch/CUDA port of allwave_tpu.

All-vs-all gap-affine / two-piece-affine global alignment of DNA
sequences with full CIGARs, MinHash ("mash") strand orientation,
deterministic sparsification and streaming PAF output, held byte for
byte to the JAX package `allwave_tpu` (the reference). The alignment
hot path runs as hand-written CUDA kernels on an NVIDIA Hopper GPU, or
as their plain PyTorch versions on the CPU (ALLWAVE_PLATFORM=cpu).

This package imports torch and never jax. Public API mirrors the
reference library facade (allwave's lib.rs:20-26).
"""

from .core.types import (
    AlignmentError,
    AlignmentMode,
    AlignmentParams,
    AlignmentResult,
    AutoSparsification,
    ConnectivitySparsification,
    NoSparsification,
    RandomSparsification,
    Sequence,
    SparsificationStrategy,
    TreeSampling,
)
from .core.cigar import cigar_bytes_to_string
from .core.paf import alignment_to_paf
from .core.scores import parse_ani_preset, parse_scores
from .orient.orientation import reverse_complement

__version__ = "0.1.0"

__all__ = [
    "AlignmentError",
    "AlignmentMode",
    "AlignmentParams",
    "AlignmentResult",
    "AutoSparsification",
    "ConnectivitySparsification",
    "NoSparsification",
    "RandomSparsification",
    "Sequence",
    "SparsificationStrategy",
    "TreeSampling",
    "alignment_to_paf",
    "cigar_bytes_to_string",
    "parse_ani_preset",
    "parse_scores",
    "process_alignments_with_callback",
    "reverse_complement",
    "__version__",
]


def process_alignments_with_callback(sequences, params, sparsification, callback):
    """Streaming all-vs-all alignment (reference: lib.rs:57-68):
    exclude_self=True, mash orientation. Lazily imports the engine so
    that light-weight users of the core API do not pay for torch
    start-up."""
    from .engine.pipeline import process_alignments_with_callback as _impl

    return _impl(sequences, params, sparsification, callback)


def __getattr__(name):
    # Lazy heavyweight exports.
    if name in ("AllPairAligner", "AllPairIterator"):
        from .engine.pipeline import AllPairAligner

        return AllPairAligner
    if name in ("read_fasta", "iter_fasta", "write_fasta"):
        from .engine import fasta

        return getattr(fasta, name)
    if name == "align_pair":
        from .wfa.simple import align_pair

        return align_pair
    if name == "KmerSketch":
        from .sketch.minhash import KmerSketch

        return KmerSketch
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
