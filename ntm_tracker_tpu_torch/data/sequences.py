"""Sequence-directory selection and batching.

The port's own copy of ntm_tracker_tpu/data/sequences.py.

get_valid_sequences <- direct_offset_output.py:94-120 (length filter with
the Py2 integer-division dilation `files[::len//min][:min]`);
sevenbyseven_get_batch <- :144-157 (concatenated frame paths).
"""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

SeqEntry = Tuple[str, List[str]]


def get_valid_sequences(
    sequences_dir: str, min_length: int = 20
) -> Tuple[List[SeqEntry], List[SeqEntry], List[SeqEntry]]:
    """List sequence dirs, keep those with >= min_length frames (dilating
    long ones), split train/val by path substring.

    Returns (all, train, val); each entry is (seqdir, [frame basenames])."""
    sequences = [
        os.path.join(sequences_dir, x) for x in sorted(os.listdir(sequences_dir))
    ]
    result: List[SeqEntry] = []
    train: List[SeqEntry] = []
    val: List[SeqEntry] = []
    for seqdir in sequences:
        if not os.path.isdir(seqdir):
            continue
        files = sorted(x[:-4] for x in os.listdir(seqdir) if x.endswith(".txt"))
        skip = len(files) // min_length  # Py2 `/` on ints == floor
        if skip == 0:
            continue
        sliced = files[::skip][:min_length]
        result.append((seqdir, sliced))
        if "train" in seqdir:
            train.append((seqdir, sliced))
        elif "val" in seqdir:
            val.append((seqdir, sliced))
        else:
            raise ValueError("expect either train or val in sequence name: " + seqdir)
    return result, train, val


def sevenbyseven_get_batch(
    index: int, batch_size: int, seqs: Sequence[SeqEntry]
) -> Tuple[List[str], int]:
    """Concatenate the frame paths of batch_size sequences starting at index."""
    seq_batch = seqs[index : index + batch_size]
    index += batch_size
    frame_names: List[str] = []
    for seq, frames in seq_batch:
        frame_names += [os.path.join(seq, x) for x in frames]
    return frame_names, index
