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
# Not ported: mtmconvol_time_sharded, the multi-device layer (ROADMAP
# Queue 1 item 14).

import torch

from .spectral import detrend, spectral_convert

__all__ = ["mtmconvol", "frame_windows"]


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
    frames = detrend(frame_windows(data.to(torch.float32), nperseg, centers, hop, n_time),
                     polyremoval, dim=-1)
    tapers = tapers.to(frames.device, frames.dtype)
    tapered = frames[:, :, None] * tapers[:, None, :]  # (B, nTime, K, C, nperseg)
    ftr = torch.fft.rfft(tapered, n=nperseg, dim=-1)
    if freq_idx is not None:
        ftr = ftr.index_select(-1, torch.as_tensor(freq_idx, device=ftr.device))
    spec = spectral_convert(ftr, output)
    if not keeptapers:
        spec = spec.mean(dim=2, keepdim=True)
    return spec.transpose(-1, -2)
