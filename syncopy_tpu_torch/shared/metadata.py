# -*- coding: utf-8 -*-
#
# Compute-metadata side channel.
#
# Parity target: reference syncopy/shared/metadata.py:11-391. The reference
# funnels per-chunk computeFunction extras through per-worker HDF5 groups
# with `__<trial>_<chunk>` key suffixes and re-collects them from (virtual)
# datasets. Here the channel is direct: a compute routine's
# `process_single_trial`/`process_batch_sum` may return
# ``(output, aux_dict)``; the engine device-fetches the aux entries after
# each chunk and exposes them as ``cr.aux_info`` (engine/routine.py). The
# helpers below keep the reference's label conventions for provenance
# recorded into ``out.info``.

import numpy as np

__all__ = [
    "encode_unique_md_label",
    "decode_unique_md_label",
    "metadata_from_aux_info",
    "check_freq_hashes",
]


def encode_unique_md_label(label, trial_idx, chunk_idx=0):
    """``label -> label__<trial>_<chunk>`` (reference metadata.py:220)."""
    return "{}__{}_{}".format(label, int(trial_idx), int(chunk_idx))


def decode_unique_md_label(unique_label):
    """Inverse of :func:`encode_unique_md_label`
    (reference metadata.py:225)."""
    label, _, suffix = unique_label.rpartition("__")
    trial, _, chunk = suffix.partition("_")
    return label, int(trial), int(chunk)


def metadata_from_aux_info(aux_info):
    """Normalize an engine aux-info dict to JSON-serializable values."""
    out = {}
    for key, val in aux_info.items():
        arr = np.asarray(val)
        if arr.ndim == 0:
            out[key] = arr.item()
        else:
            out[key] = arr.tolist()
    return out


def check_freq_hashes(hashes, out):
    """
    Assert all per-trial frequency-axis hashes agree (the reference
    computes a blake2b digest of each chunk's freq axis and compares,
    metadata.py:297). With batched static-shape execution a mismatch is
    impossible by construction, so this reduces to a uniqueness check.
    """
    uniq = set(np.asarray(hashes).ravel().tolist())
    if len(uniq) > 1:
        from .errors import SPYWarning

        SPYWarning("Frequency axes differ across trials: {}".format(uniq))
        return False
    return True
