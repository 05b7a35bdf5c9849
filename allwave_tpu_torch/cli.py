"""Command-line interface of the PyTorch port — the same flags, default
values, stderr messages and PAF/progress output contracts as
allwave_tpu/cli.py (itself flag-for-flag compatible with the reference
allwave's main.rs:30-80).

Usage: python -m allwave_tpu_torch.cli -i input.fa [-o out.paf] [options]

The device follows ALLWAVE_PLATFORM: `cpu` runs the plain PyTorch
versions of the kernels, anything else the CUDA kernels on the GPU.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Optional

from .core.scores import parse_ani_preset, parse_scores
from .engine import paf_text
from .engine.fasta import read_fasta
from .engine.paf_text import alignment_to_paf
from .engine.pipeline import AllPairAligner
from .engine.progress import ProgressTracker
from .sparsify.pairs import parse_sparsification
from .utils.telemetry import counters

#: the most queued records the writer formats in one batch pass: a few
#: hundred 5 kb records (~400 runs each) keep the pass's arrays in cache;
#: at 512 they fall out of it and a record costs half as much again
PAF_BATCH = 256


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="allwave-tpu-torch",
        description="All-pairs pairwise sequence aligner on PyTorch/CUDA "
        "(PAF output with full CIGARs)",
    )
    p.add_argument("-i", "--input", required=True, help="Input FASTA file")
    p.add_argument("-o", "--output", default=None, help="Output PAF file (default: stdout)")
    p.add_argument(
        "-s",
        "--scores",
        default=None,
        help="Alignment scores: match,mismatch,gap_open,gap_ext[,gap_open2,gap_ext2] "
        "(default 0,5,8,2,24,1)",
    )
    p.add_argument(
        "-x",
        "--preset",
        default=None,
        help="Preset alignment parameters for different ANI levels "
        "(e.g. -x 95%% or -x 0.95); conflicts with --scores",
    )
    p.add_argument(
        "-t",
        "--threads",
        type=int,
        default=1,
        help="Host worker threads (device batching is independent of this)",
    )
    p.add_argument(
        "-p",
        "--sparsification",
        default="giant:0.99",
        help="none | auto | random:<frac> | giant:<prob> | "
        "tree:<near>:<far>:<random>[:<kmer>]",
    )
    p.add_argument("--no-progress", action="store_true", help="Disable progress output")
    p.add_argument(
        "--mash-matrix",
        action="store_true",
        help="Output mash distance matrix and exit",
    )
    p.add_argument(
        "--wfa-orientation",
        action="store_true",
        help="Use WFA edit distance for orientation detection instead of mash",
    )
    p.add_argument(
        "-k",
        "--keep-prefixes",
        default=None,
        help="Keep only sequences whose IDs start with any of these prefixes "
        "(comma-separated)",
    )
    p.add_argument(
        "--resume",
        action="store_true",
        help="Resume an interrupted run: skip pairs already present in "
        "the output PAF (requires -o) and append the rest",
    )
    p.add_argument(
        "-e",
        "--exclude-prefixes",
        default=None,
        help="Exclude sequences whose IDs start with any of these prefixes "
        "(comma-separated)",
    )
    return p


def engine_stats(snap: dict, device) -> str:
    """The end-of-run stats line: the engines' counts and the host
    seconds of their four phases (process totals)."""
    phases = ", ".join(
        f"{p} {snap['spans'].get('engine.' + p, {}).get('wall_s', 0.0):.3f}"
        for p in ("plan", "launch", "wait", "unpack")
    )
    return (
        f"engine: {snap['cells'] / 1e9:.2f} G DP cells, {snap['dispatches']} dispatches, "
        f"{snap['syncs']} syncs, {snap['reruns']} reruns on {device}; host s: {phases}"
    )


def _complete_paf_pair(line: bytes):
    """(query_id, target_id) if this byte line is a complete PAF record
    (newline-terminated, >=12 tab fields, numeric coordinate columns,
    valid strand), else None — used by --resume to ignore/truncate a
    partial record left by a crash mid-write."""
    if not line.endswith(b"\n"):
        return None
    parts = line.rstrip(b"\n").split(b"\t")
    if len(parts) < 12:
        return None
    if parts[4] not in (b"+", b"-"):
        return None
    for col in (1, 2, 3, 6, 7, 8, 9, 10, 11):
        if not parts[col].isdigit():
            return None
    try:
        return (parts[0].decode(), parts[5].decode())
    except UnicodeDecodeError:
        return None


def main(argv: Optional[List[str]] = None) -> int:
    args = build_arg_parser().parse_args(argv)

    if args.scores is not None and args.preset is not None:
        print(
            "Error: the argument '--scores' cannot be used with '--preset'",
            file=sys.stderr,
        )
        return 2
    if args.keep_prefixes is not None and args.exclude_prefixes is not None:
        print(
            "Error: the argument '--keep-prefixes' cannot be used with "
            "'--exclude-prefixes'",
            file=sys.stderr,
        )
        return 2

    try:
        sparsification = parse_sparsification(args.sparsification)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    try:
        sequences = read_fasta(args.input)
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    # prefix filtering (reference: main.rs:237-278, stderr messages are
    # part of the behavioral contract)
    if args.keep_prefixes is not None:
        prefixes = [s.strip() for s in args.keep_prefixes.split(",")]
        original = len(sequences)
        sequences = [
            s for s in sequences if any(s.id.startswith(p) for p in prefixes)
        ]
        if len(sequences) != original:
            print(
                f"Kept sequences with prefixes: {original} -> {len(sequences)} "
                f"(prefixes: {args.keep_prefixes})",
                file=sys.stderr,
            )
        if not sequences:
            print(
                "Error: No sequences match the specified keep prefixes",
                file=sys.stderr,
            )
            return 1

    if args.exclude_prefixes is not None:
        prefixes = [s.strip() for s in args.exclude_prefixes.split(",")]
        original = len(sequences)
        sequences = [
            s for s in sequences if not any(s.id.startswith(p) for p in prefixes)
        ]
        if len(sequences) != original:
            print(
                f"Excluded sequences with prefixes: {original} -> {len(sequences)} "
                f"(prefixes: {args.exclude_prefixes})",
                file=sys.stderr,
            )
        if not sequences:
            print(
                "Error: All sequences were excluded by the specified prefixes",
                file=sys.stderr,
            )
            return 1

    if args.mash_matrix:
        from .core.types import TreeSampling
        from .sketch.minhash import (
            compute_distance_matrix_with_params,
            format_distance_matrix,
        )

        kmer_size = (
            sparsification.kmer_size
            if isinstance(sparsification, TreeSampling)
            and sparsification.kmer_size is not None
            else 15
        )
        matrix = compute_distance_matrix_with_params(sequences, kmer_size, 1000)
        sys.stdout.write(format_distance_matrix(sequences, matrix))
        return 0

    if args.preset is not None:
        try:
            scores_str = parse_ani_preset(args.preset)
        except ValueError as e:
            print(f"Error: {e}", file=sys.stderr)
            return 1
        print(
            f"Using ANI preset {args.preset} -> alignment scores: {scores_str}",
            file=sys.stderr,
        )
    else:
        scores_str = args.scores if args.scores is not None else "0,5,8,2,24,1"

    try:
        params = parse_scores(scores_str)
    except ValueError as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1

    aligner = AllPairAligner(
        sequences,
        params,
        exclude_self=True,
        use_mash_orientation=not args.wfa_orientation,
        sparsification=sparsification,
        threads=args.threads,
    )

    append = False
    if args.resume:
        import os

        if not args.output:
            print("Error: --resume requires -o/--output", file=sys.stderr)
            return 2
        if os.path.exists(args.output):
            # only complete PAF records count as done: a crash mid-write
            # (the exact scenario --resume exists for) leaves a
            # truncated trailing line, which must be dropped from the
            # file AND realigned, never kept as a corrupt record
            done = set()
            good_end = 0
            with open(args.output, "rb") as f:
                for line in f:
                    rec = _complete_paf_pair(line)
                    if rec is None:
                        break
                    done.add(rec)
                    good_end += len(line)
                file_end = f.seek(0, 2)
            if good_end < file_end:
                with open(args.output, "rb+") as f:
                    f.truncate(good_end)
                print(
                    f"Resuming: dropped an incomplete trailing record "
                    f"from {args.output}",
                    file=sys.stderr,
                )
            skipped = aligner.skip_done_pairs(done)
            if skipped:
                print(
                    f"Resuming: {skipped} pairs already in {args.output}, "
                    f"{aligner.pair_count()} remaining",
                    file=sys.stderr,
                )
                append = True
    total = aligner.pair_count()

    out = (
        open(args.output, "a" if append else "w")
        if args.output
        else sys.stdout
    )
    interactive = args.output is None and sys.stderr.isatty()
    progress = ProgressTracker(
        total, enabled=not args.no_progress, interactive=interactive
    )
    # dedicated writer thread, mirroring the reference's mpsc channel ->
    # writer design (main.rs:347-367): PAF serialization and IO overlap
    # the device compute of the next batch
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=65536)
    writer_err: List[BaseException] = []

    def writer():
        # a batch is the next record and those already waiting behind it,
        # up to PAF_BATCH: the writer never waits for more, so a job's
        # last records are written as soon as they arrive
        ended = False
        try:
            while not ended:
                batch = [q.get()]
                while len(batch) < PAF_BATCH and batch[-1] is not None:
                    try:
                        batch.append(q.get_nowait())
                    except queue.Empty:
                        break
                if batch[-1] is None:
                    ended = True
                    batch.pop()
                if batch:
                    # the CIGAR text of the whole batch in one pass; the
                    # line is still made by one call a record
                    with paf_text.prepared(batch):
                        out.writelines([alignment_to_paf(r, sequences) + "\n" for r in batch])
        except BaseException as e:  # disk full, I/O error, ...
            writer_err.append(e)
            # keep draining so producers never block on a full queue
            # once the writer is dead; the error re-raises in cb/main
            if not ended:
                while q.get() is not None:
                    pass

    wt = threading.Thread(target=writer, daemon=True)
    wt.start()
    try:
        def cb(result):
            if writer_err:
                raise writer_err[0]
            q.put(result)
            progress.update()

        aligner.for_each_with_callback(cb)
        q.put(None)
        with counters.span("cli.drain"):
            wt.join()
        if writer_err:
            raise writer_err[0]
        progress.finish()
        snap = counters.snapshot()
        if not args.no_progress and snap["cells"]:
            print(engine_stats(snap, aligner.device), file=sys.stderr)
    finally:
        # stop the writer before closing the file — it may be mid-write
        # when the pipeline raises
        if wt.is_alive():
            import queue as _queue

            try:
                q.put_nowait(None)
            except _queue.Full:
                pass
            wt.join(timeout=5.0)
        if args.output:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
