# -*- coding: utf-8 -*-
#
# load_tdt: import Tucker-Davis Technologies recordings.
#
# Parity target: reference syncopy/io/load_tdt.py:24-880. Reads the TDT tank
# block format: the `.tsq` event-index file plus `.tev`/`.sev` payload files.
# Full store census: continuous streams assemble into AnalogData, scalar
# stores (strobe values), epoc on/offset stores (with buddy pairing) and
# spike-snippet stores (timestamps, channel, sortcode) land in ``.info`` —
# the reference's Trigger_*/PDio_* metadata convention (load_tdt.py:36-43).

import glob
import os
import struct

import numpy as np

from ..shared.errors import SPYIOError, SPYValueError, SPYWarning

__all__ = ["load_tdt"]

# TDT .tsq record: 40 bytes
_TSQ_DTYPE = np.dtype(
    [
        ("size", "<i4"),
        ("type", "<i4"),
        ("code", "<u4"),
        ("channel", "<u2"),
        ("sortcode", "<u2"),
        ("timestamp", "<f8"),
        ("offset", "<u8"),  # file offset (or the payload value for scalars/epocs)
        ("format", "<i4"),
        ("frequency", "<f4"),
    ]
)

_TDT_FORMATS = {0: np.float32, 1: np.int32, 2: np.int16, 3: np.int8, 4: np.float64, 5: np.int64}

# event-type constants (reference load_tdt.py:125-153)
_EVTYPE_STRON = 0x0101  # epoc onset
_EVTYPE_STROFF = 0x0102  # epoc offset
_EVTYPE_SCALAR = 0x0201
_EVTYPE_STREAM = 0x8101
_EVTYPE_SNIP = 0x8201
_EVTYPE_MARK = 0x8801  # strobe/trigger store (epoc onset carrying codes)
_EVTYPE_MASK = 0x0000FF0F
_STARTBLOCK = 0x0001
_STOPBLOCK = 0x0002


def _code_to_name(code):
    return int(code).to_bytes(4, byteorder="little").decode("cp437").strip()


def _name_to_code(name):
    name = (str(name) + "    ")[:4]
    return struct.unpack("<I", name.encode("ascii"))[0]


def _type_str(evtype):
    """Classify a .tsq event type word (reference code_to_type)."""
    if evtype in (_EVTYPE_STRON, _EVTYPE_MARK):
        return "epoc_onset"
    if evtype == _EVTYPE_STROFF:
        return "epoc_offset"
    if evtype == _EVTYPE_SNIP:
        return "snips"
    if evtype & _EVTYPE_MASK == _EVTYPE_STREAM:
        return "streams"
    if evtype == _EVTYPE_SCALAR:
        return "scalars"
    return "unknown"


def _payload_values(recs):
    """Scalar/epoc records carry their value in the offset field's bytes."""
    return recs["offset"].view(np.float64)


def load_tdt(data_path, start_code=None, end_code=None, subtract_median=False,
             stream=None):
    """
    Read a TDT block directory into an :class:`~syncopy_tpu.AnalogData`.

    All non-stream stores are parsed into ``.info``:

    - scalar / Mark strobe stores: ``<name>_code`` (strobe values),
      ``<name>_timestamp`` (s, block-relative), ``<name>_sample`` (rounded
      to the stream's sampling rate) — plus ``Trigger_*`` aliases for the
      trigger store (reference load_tdt.py:36-43),
    - epoc stores: ``<name>_onset`` / ``<name>_offset`` (s) and
      ``<name>_data``, with offset stores paired to their onset buddy,
    - snippet stores: ``<name>_ts`` / ``<name>_chan`` / ``<name>_sortcode``.

    Parameters
    ----------
    stream : str or None
        Name of the stream store to assemble (e.g. ``"LFPs"``); None picks
        the store with the most records.
    start_code, end_code : int, str or None
        Integers are strobe VALUES matched against ``Trigger_code``
        (reference semantics, load_tdt.py:808-849); strings name a
        scalar/epoc store whose event times delimit trials.
    subtract_median : bool
        Subtract each channel's median.
    """
    data_path = os.path.abspath(os.path.expanduser(str(data_path)))
    if not os.path.isdir(data_path):
        raise SPYIOError(data_path, exists=False)
    tsq_files = sorted(glob.glob(os.path.join(data_path, "*.tsq")))
    if not tsq_files:
        # SEV-only recording: concatenate per-channel .sev files
        sev_files = sorted(glob.glob(os.path.join(data_path, "*.sev")))
        if sev_files:
            return _load_sev_only(sev_files)
        raise SPYValueError(
            legal="directory containing a .tsq index or .sev files",
            varname="data_path",
            actual=data_path,
        )
    if len(tsq_files) > 1:
        raise SPYValueError(
            legal="exactly one .tsq index per block", varname="data_path",
            actual=", ".join(os.path.basename(t) for t in tsq_files),
        )

    tsq = np.fromfile(tsq_files[0], dtype=_TSQ_DTYPE)
    tsq = tsq[tsq["code"] > 0]  # drop bad headers (reference :256-262)

    # block start time: the STARTBLOCK marker record (reference :227-231)
    start_marks = tsq[tsq["type"] == _STARTBLOCK]
    if start_marks.size:
        t_block = float(start_marks["timestamp"][0])
    else:
        SPYWarning("TDT block start marker not found")
        t_block = float(tsq["timestamp"].min())

    # ---------------- store census ---------------- #
    stores = {}  # name -> dict(type_str, recs)
    body = tsq[(tsq["type"] != _STARTBLOCK) & (tsq["type"] != _STOPBLOCK)]
    for code in np.unique(body["code"]):
        recs = body[body["code"] == code]
        ts = _type_str(int(recs["type"][0]))
        if ts == "unknown":
            continue
        stores[_code_to_name(code)] = {"type": ts, "recs": recs, "code": int(code)}

    stream_names = [n for n, s in stores.items() if s["type"] == "streams"]
    if not stream_names:
        raise SPYValueError(legal="block with stream events", varname="data_path", actual=data_path)
    if stream is not None:
        if str(stream) not in stream_names:
            raise SPYValueError(
                legal="one of the stream stores {}".format(stream_names),
                varname="stream", actual=str(stream),
            )
        stream_name = str(stream)
    else:
        stream_name = max(stream_names, key=lambda n: stores[n]["recs"].size)

    # ---------------- assemble the stream ---------------- #
    tev_files = sorted(glob.glob(os.path.join(data_path, "*.tev")))
    if not tev_files:
        raise SPYIOError(os.path.join(data_path, "*.tev"), exists=False)
    ev = stores[stream_name]["recs"]
    fs = float(ev["frequency"][0])
    fmt = _TDT_FORMATS.get(int(ev["format"][0]), np.float32)
    itemsize = np.dtype(fmt).itemsize
    npts = (int(ev["size"][0]) - 10) * 4 // itemsize

    channels = np.unique(ev["channel"])
    chunks = {int(c): [] for c in channels}
    with open(tev_files[0], "rb") as f:
        for rec in ev:
            f.seek(int(rec["offset"]))
            buf = np.fromfile(f, dtype=fmt, count=npts)
            chunks[int(rec["channel"])].append(buf)
    nmin = min(sum(len(b) for b in blks) for blks in chunks.values())
    data = np.empty((nmin, len(channels)), dtype=np.float32)
    for j, c in enumerate(sorted(chunks)):
        data[:, j] = np.concatenate(chunks[c])[:nmin]
    if subtract_median:
        data -= np.median(data, axis=0, keepdims=True)

    from ..datatype.continuous_data import AnalogData

    adata = AnalogData(data=data, samplerate=fs)
    adata.channel = ["{}_{}".format(stream_name, c) for c in sorted(chunks)]
    # stream onset relative to the block start: event timestamps below are
    # converted to STREAM samples, so the stream's own start is the origin
    t0_stream = float(ev["timestamp"].min())

    # ---------------- non-stream stores -> .info ---------------- #
    trigger_name = None
    onset_names = []
    for name, st in sorted(stores.items()):
        recs = st["recs"]
        rel_ts = recs["timestamp"] - t0_stream
        if st["type"] == "scalars" or (st["type"] == "epoc_onset" and int(recs["type"][0]) == _EVTYPE_MARK):
            adata.info[name + "_code"] = _payload_values(recs).astype(int).tolist()
            adata.info[name + "_timestamp"] = rel_ts.tolist()
            adata.info[name + "_sample"] = np.round(rel_ts * fs).astype(int).tolist()
            if trigger_name is None or name == "Mark":
                trigger_name = name
        elif st["type"] == "epoc_onset":
            onsets = rel_ts
            offsets = np.append(onsets[1:], np.inf)
            adata.info[name + "_onset"] = onsets.tolist()
            adata.info[name + "_offset"] = offsets.tolist()
            adata.info[name + "_data"] = _payload_values(recs).tolist()
            onset_names.append(name)
        elif st["type"] == "snips":
            adata.info[name + "_ts"] = rel_ts.tolist()
            adata.info[name + "_chan"] = recs["channel"].astype(int).tolist()
            adata.info[name + "_sortcode"] = recs["sortcode"].astype(int).tolist()

    # epoc offset stores override the inferred offsets of their onset buddy
    # (the buddy name lives in the channel+sortcode words; reference :429-455)
    for name, st in sorted(stores.items()):
        if st["type"] != "epoc_offset":
            continue
        recs = st["recs"]
        buddy_word = int(recs["channel"][0]) | (int(recs["sortcode"][0]) << 16)
        buddy = _code_to_name(buddy_word)
        if buddy not in onset_names:
            SPYWarning("{} buddy epoc '{}' not found, skipping".format(name, buddy))
            continue
        offsets = (recs["timestamp"] - t0_stream).astype(float)
        onsets = np.asarray(adata.info[buddy + "_onset"], dtype=float)
        bdata = np.asarray(adata.info[buddy + "_data"], dtype=float)
        # fix time ranges (reference :444-454)
        if offsets.size and onsets.size and offsets[0] < onsets[0]:
            onsets = np.append(0.0, onsets)
            bdata = np.append(bdata[:1], bdata)
        if onsets.size and (not offsets.size or onsets[-1] > offsets[-1]):
            offsets = np.append(offsets, np.inf)
        adata.info[buddy + "_onset"] = onsets.tolist()
        adata.info[buddy + "_offset"] = offsets.tolist()
        adata.info[buddy + "_data"] = bdata.tolist()

    if trigger_name is not None:
        for suffix in ("code", "timestamp", "sample"):
            adata.info["Trigger_" + suffix] = adata.info["{}_{}".format(trigger_name, suffix)]

    adata.log = "loaded TDT block {} (stream '{}', {} stores)".format(
        data_path, stream_name, len(stores)
    )

    # ---------------- trialdefinition ---------------- #
    if start_code is not None:
        adata.trialdefinition = _trialdef_from_codes(
            adata, stores, start_code, end_code, t0_stream, fs, nmin
        )
    return adata


def _trialdef_from_codes(adata, stores, start_code, end_code, t0_stream, fs, nmin):
    """Trial bounds from trigger codes. Integers are strobe VALUES matched
    against Trigger_code (reference _mk_trialdef, load_tdt.py:808-849);
    strings name a store whose event times delimit trials."""
    if isinstance(start_code, str):
        if start_code not in stores:
            raise SPYValueError(
                legal="one of the stores {}".format(sorted(stores)),
                varname="start_code", actual=start_code,
            )
        starts = stores[start_code]["recs"]["timestamp"] - t0_stream
        if end_code is not None:
            if str(end_code) not in stores:
                raise SPYValueError(
                    legal="one of the stores {}".format(sorted(stores)),
                    varname="end_code", actual=str(end_code),
                )
            ends = stores[str(end_code)]["recs"]["timestamp"] - t0_stream
        else:
            ends = np.append(starts[1:], nmin / fs)
        rows = []
        for s, e in zip(starts, ends):
            s_smp, e_smp = int(round(s * fs)), int(round(e * fs))
            if 0 <= s_smp < e_smp <= nmin:
                rows.append([s_smp, e_smp, 0])
        if not rows:
            raise SPYValueError(legal="at least one in-bounds trial", varname="start_code",
                                actual=str(start_code))
        return np.asarray(rows, dtype=float)

    # integer strobe values (reference semantics)
    if end_code is None:
        raise SPYValueError(legal="trigger codes for both trial start and end",
                            varname="end_code", actual=str(end_code))
    trg_codes = np.asarray(adata.info.get("Trigger_code", []), dtype=int)
    trg_sample = np.asarray(adata.info.get("Trigger_sample", []), dtype=int)
    trl_starts = trg_sample[trg_codes == int(start_code)]
    trl_ends = trg_sample[trg_codes == int(end_code)]
    if trl_starts.size == 0:
        raise SPYValueError(legal="at least one occurrence of trial start code",
                            varname="start_code", actual=str(start_code))
    if trl_ends.size == 0:
        raise SPYValueError(legal="at least one occurrence of trial end code",
                            varname="end_code", actual=str(end_code))
    if trl_starts.size != trl_ends.size:
        SPYWarning(
            "Found {} trial starts and {} trial end codes — truncating".format(
                trl_starts.size, trl_ends.size)
        )
    n = min(trl_starts.size, trl_ends.size)
    starts, ends = trl_starts[:n], trl_ends[:n]
    # only keep in-bounds, forward trials (like the store-name path): an
    # end strobe before its start or past the recording would otherwise
    # attach an invalid trialdefinition silently
    good = (starts >= 0) & (starts < ends) & (ends <= nmin)
    if not good.all():
        SPYWarning(
            "Dropping {} out-of-bounds/reversed strobe trial(s)".format(int((~good).sum()))
        )
    starts, ends = starts[good], ends[good]
    if starts.size == 0:
        raise SPYValueError(legal="at least one in-bounds strobe trial",
                            varname="start_code", actual=str(start_code))
    trldef = np.zeros((starts.size, 3))
    trldef[:, 0] = starts
    trldef[:, 1] = ends
    return trldef


def _load_sev_only(sev_files):
    """Per-channel .sev files: 40-byte header + raw samples."""
    from ..datatype.continuous_data import AnalogData

    sigs = []
    fs = None
    for path in sev_files:
        with open(path, "rb") as f:
            header = f.read(40)
            fmt_code = struct.unpack("<B", header[24:25])[0] & 0x7
            dtype = _TDT_FORMATS.get(fmt_code, np.float32)
            fs_this = struct.unpack("<f", header[32:36])[0]
            fs = fs or fs_this
            sigs.append(np.fromfile(f, dtype=dtype).astype(np.float32))
    nmin = min(s.size for s in sigs)
    data = np.column_stack([s[:nmin] for s in sigs])
    adata = AnalogData(data=data, samplerate=float(fs or 1.0))
    adata.channel = [os.path.basename(p).rsplit(".", 1)[0] for p in sev_files]
    return adata
