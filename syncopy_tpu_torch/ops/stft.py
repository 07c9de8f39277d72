# -*- coding: utf-8 -*-
#
# Sliding-window (multi-)tapered Fourier transform: the mtmconvol / STFT
# op.
#
# Port of syncopy_tpu/ops/stft.py::mtmconvol, batched over trials. Windows
# are framed out of the zero-padded trial: `Tensor.unfold` (a view) for
# evenly spaced centres, an index gather for explicit centres, which may
# differ from trial to trial. The frames keep their samples on the last
# axis, so the batched rfft runs over contiguous rows.
# mtmconvol_time_sharded splits one recording's time axis over a mesh
# axis, with the window halo exchanged between neighbouring positions.

import torch

from .spectral import detrend, spectral_convert

__all__ = ["mtmconvol", "frame_windows", "mtmconvol_time_sharded"]


def frame_windows(data, nperseg, centers=None, hop=1, n_time=None):
    """
    ``(B, nTime, nChannels, nperseg)`` windows of a ``(B, nSamples,
    nChannels)`` batch, framed as the JAX package frames them
    (syncopy_tpu/ops/stft.py:55-59): the trial gets ``nperseg // 2`` zeros
    in front and `nperseg` zeros behind, and centre ``c`` takes the padded
    window ``[c, c + nperseg)``, i.e. trial samples from ``c - nperseg//2``
    on, zero-extended past both edges.

    `centers` is a ``(B, nTime)`` integer tensor of explicit centres (an
    index gather; indices past the padded trial are clamped to it, and
    negative ones count from its end, as a JAX gather does); without it,
    the centres are ``0, hop, 2 hop, ...`` (`n_time` of them), framed by
    ``Tensor.unfold``.
    """
    B, T, C = data.shape
    x = torch.nn.functional.pad(data.transpose(1, 2), (nperseg // 2, nperseg))  # (B, C, Tp)
    if centers is None:
        return x.unfold(2, nperseg, hop)[:, :, :n_time].transpose(1, 2)
    Tp = x.shape[2]
    idx = centers.to(torch.int64)[:, :, None] + torch.arange(nperseg, device=data.device)
    idx = torch.where(idx < 0, idx + Tp, idx).clamp(0, Tp - 1)  # (B, nTime, nperseg)
    n = idx.shape[1]
    frames = torch.gather(x, 2, idx.reshape(B, 1, -1).expand(B, C, n * nperseg))
    return frames.reshape(B, C, n, nperseg).transpose(1, 2)


def mtmconvol(data, tapers, nperseg, centers=None, hop=1, n_time=None, polyremoval=None,
              output="fourier", keeptapers=True, freq_idx=None):
    """
    Tapered STFT of a batch of trials.

    Parameters
    ----------
    data : (B, nSamples, nChannels) real tensor
    tapers : (nTaper, nperseg) tensor, the normalized taper bank
        (:func:`~syncopy_tpu_torch.ops.windows.make_tapers` with
        ``signal_length = pad_length = nperseg``)
    nperseg : int, window length in samples
    centers, hop, n_time : the window centres (see :func:`frame_windows`)
    polyremoval : None/0/1, per-window detrend
    output : str, spectral output conversion
    keeptapers : bool, keep the taper axis or average it out
    freq_idx : optional int array, frequency bins to keep

    Returns
    -------
    spec : (B, nTime, nTaper|1, nFreq, nChannels)
    """
    frames = frame_windows(data.to(torch.float32), nperseg, centers, hop, n_time)
    return _frames_spectra(frames, tapers, nperseg, polyremoval, output, keeptapers, freq_idx)


def _frames_spectra(frames, tapers, nperseg, polyremoval, output, keeptapers, freq_idx):
    """``(B, nTime, nTaper|1, nFreq, nChannels)`` spectra of ``(B, nTime,
    nChannels, nperseg)`` frames: detrend, taper, rfft, convert."""
    frames = detrend(frames, polyremoval, dim=-1)
    tapers = tapers.to(frames.device, frames.dtype)
    tapered = frames[:, :, None] * tapers[:, None, :]  # (B, nTime, K, C, nperseg)
    ftr = torch.fft.rfft(tapered, n=nperseg, dim=-1)
    if freq_idx is not None:
        ftr = ftr.index_select(-1, torch.as_tensor(freq_idx, device=ftr.device))
    spec = spectral_convert(ftr, output)
    if not keeptapers:
        spec = spec.mean(dim=2, keepdim=True)
    return spec.transpose(-1, -2)


def mtmconvol_time_sharded(data, tapers, nperseg, mesh, axis_name="trial", polyremoval=None,
                           output="fourier", keeptapers=True, freq_idx=None):
    """
    Tapered STFT with one window per sample (``toi='all'``) of one
    recording whose TIME axis is split over the positions of `mesh` along
    `axis_name` (syncopy_tpu/ops/stft.py::mtmconvol_time_sharded, the
    context-parallel analog for recordings too long for one device): each
    position receives ``nperseg // 2`` samples from its left neighbour and
    ``nperseg - nperseg // 2`` from its right one (zeros at the
    recording's edges), frames and transforms its own window centres, and
    its spectrogram stays on its device. Equal to :func:`mtmconvol` with
    centres ``0 .. nSamples - 1`` up to FFT rounding. On a mesh that spans
    processes every rank calls this with the same arguments and frames
    only its own positions' blocks.

    Parameters
    ----------
    data : (nSamples, nChannels) array or tensor, nSamples divisible by
        the axis size; each block at least `nperseg` long
    tapers : (nTaper, nperseg) taper bank
    mesh : :class:`~syncopy_tpu_torch.parallel.mesh.Mesh`

    Returns
    -------
    spec : :class:`~syncopy_tpu_torch.parallel.mesh.ShardedTensor` of
        (nSamples / n, nTaper|1, nFreq, nChannels) blocks along dim 0
        (None for another rank's)
    """
    from ..parallel.mesh import (ShardedTensor, axis_devices, axis_ranks, check_mesh,
                                 device_context, halo_exchange, split_along)

    devices, ranks = axis_devices(check_mesh(mesh), axis_name), axis_ranks(mesh, axis_name)
    T, C = data.shape
    if T % len(devices):
        raise ValueError("nSamples must be divisible by the mesh axis size")
    T_local = T // len(devices)
    if T_local < nperseg:
        raise ValueError(
            "local shard ({} samples) shorter than nperseg ({})".format(T_local, nperseg))
    half = nperseg // 2
    blocks = split_along(torch.as_tensor(data).to(torch.float32), devices, ranks=ranks)
    tapers = torch.as_tensor(tapers)
    out = []
    for ext, d in zip(halo_exchange(blocks, half, nperseg - half, ranks), devices):
        if ext is None:
            out.append(None)
            continue
        with device_context(d):
            # local centre c frames ext[c : c + nperseg], as mtmconvol's
            # zero-padded gather frames the whole recording
            frames = ext.transpose(0, 1).unfold(1, nperseg, 1)[:, :T_local].transpose(0, 1)
            out.append(_frames_spectra(frames[None], tapers, nperseg, polyremoval, output,
                                       keeptapers, freq_idx)[0])
    n_freq = nperseg // 2 + 1 if freq_idx is None else len(freq_idx)
    shape = (T, tapers.shape[0] if keeptapers else 1, n_freq, C)
    return ShardedTensor(out, dim=0, shape=shape, ranks=ranks)
