"""The on-device feature front end: raw audio -> spliced log-mel on the
card, in PyTorch.

Port of `fseend_tpu/ops/features_tpu.py`, the device mirror of the host DSP
in `ops/features.py`.  A serving card sustains hundreds of thousands of
frames per second, far beyond what one host core featurizes, and raw audio
is about 7x smaller than the spliced features it becomes (context 7,
subsampling 10), so the front end runs beside the model.  None of it is a
Pallas kernel in the JAX package; here it is torch library calls (an index
gather for the frames, `torch.fft.rfft`, a float32 matmul against the mel
matrix that `ops/features.py` builds).

Pipeline (the host path's math):
  center-padded Hann STFT (librosa conventions, the window zero-padded to
  n_fft, the "drop the last frame when len % hop == 0" rule; the frames
  are gathered by index, not taken from `torch.stft`, whose padding and
  window placement differ) -> |.|^2 -> Slaney mel -> log10 ->
  {none, mn, mvn, cummn} normalization -> +/-context splice -> subsample.

`logmel23_swn` (the 2-means speech-weighted mean) is host-only: its
data-dependent iteration belongs to offline training data.

Entry points run on the card unless the caller names another device.
"""

from __future__ import annotations

import numpy as np
import torch

from fseend_tpu_torch.models.ls_eend import resolve_device
from fseend_tpu_torch.ops import features as F


def _n_fft(frame_size: int) -> int:
    return 1 << (int(frame_size) - 1).bit_length()


def _logmel(x: torch.Tensor, n_frames: int, shift: int, window: torch.Tensor,
            mel: torch.Tensor) -> torch.Tensor:
    """x (B, n) padded audio -> log10 mel power (B, n_frames, n_mels) of the
    frames starting at 0, shift, 2 shift, ..."""
    n_fft = window.shape[0]
    idx = (torch.arange(n_frames, device=x.device)[:, None] * shift
           + torch.arange(n_fft, device=x.device)[None, :])
    spec = torch.fft.rfft(x[:, idx] * window, dim=-1)
    power = spec.real.square() + spec.imag.square()
    return torch.log10(torch.clamp_min(power @ mel.T, 1e-10))


def _tables(frame_size: int, sr: int, n_mels: int, device):
    """The window (n_fft,) and the mel matrix (n_mels, n_fft // 2 + 1) as
    float32 tensors on `device`."""
    n_fft = _n_fft(frame_size)
    window = torch.as_tensor(F._stft_window(frame_size, n_fft), dtype=torch.float32,
                             device=device)
    mel = torch.as_tensor(F.mel_filterbank(sr, n_fft, n_mels), device=device)
    return window, mel


def _splice(y: torch.Tensor, c: int) -> torch.Tensor:
    """(B, T, D) -> (B, T, (2c+1) D): +-c frames stacked, zero padded."""
    if c == 0:
        return y
    T = y.shape[1]
    ypad = torch.nn.functional.pad(y, (0, 0, c, c))
    return torch.cat([ypad[:, j:j + T] for j in range(2 * c + 1)], dim=-1)


def logmel_frontend(audio, *, frame_size: int = 200, frame_shift: int = 80,
                    context_size: int = 7, subsampling: int = 10,
                    input_transform: str = "logmel23_mn", sr: int = 8000,
                    n_mels: int = 23, device=None) -> torch.Tensor:
    """audio (B, n_samples) -> (B, ceil(T / subsampling), (2c+1) n_mels)
    float32 features on `device` (the card unless the caller names
    another), row for row those of `ops/features.extract_fbank`."""
    device = resolve_device(device)
    audio = torch.as_tensor(audio, dtype=torch.float32).to(device)
    B, n_samples = audio.shape
    window, mel = _tables(frame_size, sr, n_mels, device)
    n_fft = window.shape[0]
    x = torch.nn.functional.pad(audio, (n_fft // 2, n_fft // 2))
    n_frames = 1 + (x.shape[1] - n_fft) // frame_shift
    if n_samples % frame_shift == 0:
        n_frames -= 1
    out = _logmel(x, n_frames, frame_shift, window, mel)

    if input_transform in ("logmel23", "logmel"):
        pass
    elif input_transform.endswith("_mn"):
        out = out - out.mean(dim=1, keepdim=True)
    elif input_transform.endswith("_mvn"):
        out = out - out.mean(dim=1, keepdim=True)
        out = out / torch.clamp_min(out.std(dim=1, keepdim=True, unbiased=False), 1e-10)
    elif input_transform.endswith("_cummn"):
        counts = torch.arange(1, n_frames + 1, dtype=out.dtype, device=device)[None, :, None]
        out = out - out.cumsum(dim=1) / counts
    else:
        raise ValueError(f"unsupported on-device transform: {input_transform}")
    return _splice(out, context_size)[:, ::subsampling]


def extract_fbank_batch(wavs, feat_cfg, device=None) -> torch.Tensor:
    """(B, n_samples) raw audio + a `data/dataset.FeatureConfig` -> device
    features, matching `ops/features.extract_fbank` per row."""
    return logmel_frontend(
        wavs, frame_size=feat_cfg.frame_size, frame_shift=feat_cfg.frame_shift,
        context_size=feat_cfg.context_size, subsampling=feat_cfg.subsampling,
        input_transform=feat_cfg.input_transform or "logmel23", sr=feat_cfg.rate,
        device=device)


class StreamingLogmel:
    """Blockwise raw audio -> spliced log-mel with carried state, equal to
    the offline pipeline on the stream's concatenation (the same frames,
    the same cumulative normalization, the same splice zeros).

    Feed fixed-size audio blocks with block_samples % (frame_shift *
    subsampling) == 0.  The STFT tail (the samples not yet framed), the
    last 2c mel frames and the cumulative-mean sums are carried across
    blocks as tensors on the device; the counts are host integers.  Each
    block emits (B, n, (2c+1) n_mels): the output lags the input by
    `context_size` STFT frames (the splice look-ahead), and `flush()`
    drains it with the offline right-pad semantics, a ragged remainder
    included.

    Transforms: logmel23 (none) and logmel23_cummn, the causal ones;
    per-recording mn / mvn need the future by definition."""

    def __init__(self, batch: int, block_samples: int, *, frame_size: int = 200,
                 frame_shift: int = 80, context_size: int = 7, subsampling: int = 10,
                 input_transform: str = "logmel23_cummn", sr: int = 8000,
                 n_mels: int = 23, device=None):
        if input_transform not in ("logmel23", "logmel23_cummn"):
            raise ValueError(f"streaming transform must be causal, got {input_transform}")
        if block_samples % (frame_shift * subsampling):
            raise ValueError(f"block_samples={block_samples} is not a multiple of "
                             f"frame_shift * subsampling = {frame_shift * subsampling}")
        self.device = resolve_device(device)
        self.B, self.S = batch, block_samples
        self.shift, self.c, self.sub = frame_shift, context_size, subsampling
        self.n_mels, self.tf = n_mels, input_transform
        self.window, self.mel = _tables(frame_size, sr, n_mels, self.device)
        self.n_fft = self.window.shape[0]
        self.reset()

    def reset(self):
        def z(*shape):
            return torch.zeros(shape, dtype=torch.float32, device=self.device)

        self.tail = z(self.B, self.n_fft // 2)          # the center pre-pad, then the tail
        self.melbuf = z(self.B, 2 * self.c, self.n_mels)
        self.cum_sum = z(self.B, 1, self.n_mels)
        self.n_mel = 0            # mel frames produced so far
        self.n_spliced = 0        # spliced frames emitted so far
        self.n_samples = 0

    def _normalize(self, mel: torch.Tensor) -> torch.Tensor:
        """The cumulative mean over the whole stream so far, frame by frame
        (updates the carried sums)."""
        if not self.tf.endswith("_cummn"):
            return mel
        csum = self.cum_sum + mel.cumsum(dim=1)
        counts = (self.n_mel + torch.arange(1, mel.shape[1] + 1, dtype=torch.float32,
                                            device=self.device))[None, :, None]
        self.cum_sum = csum[:, -1:]
        return mel - csum / counts

    def process_block(self, block) -> torch.Tensor:
        """block (B, block_samples) -> (B, n_emitted, (2c+1) n_mels) on the
        device."""
        block = torch.as_tensor(block, dtype=torch.float32).to(self.device)
        if tuple(block.shape) != (self.B, self.S):
            raise ValueError(f"audio block {tuple(block.shape)}: expected ({self.B}, {self.S})")
        x = torch.cat([self.tail, block], dim=1)
        n_frames = 1 + (x.shape[1] - self.n_fft) // self.shift
        mel = self._normalize(_logmel(x, n_frames, self.shift, self.window, self.mel))
        self.tail = x[:, n_frames * self.shift:]
        # the splice window over cat(previous 2c, new) covers centers
        # [n_mel - c, n_mel + n_frames - c); emit the valid, subsampled ones
        cat = torch.cat([self.melbuf, mel], dim=1)
        start = self.n_mel - self.c
        first = max(0, start)
        first += (-first) % self.sub
        stop = self.n_mel + n_frames - self.c
        parts = [cat[:, j:j + n_frames] for j in range(2 * self.c + 1)]
        out = torch.cat(parts, dim=-1)[:, first - start:max(stop - start, 0):self.sub]
        self.melbuf = cat[:, cat.shape[1] - 2 * self.c:]
        self.n_mel += n_frames
        self.n_samples += self.S
        self.n_spliced += out.shape[1]
        return out

    def flush(self, last=None) -> torch.Tensor:
        """End of stream: the offline right pad (n_fft // 2 zeros), the
        hop-divisible last-frame drop, and the splice look-ahead drained.
        last: an optional ragged final chunk (B, r), r < block_samples."""
        if last is not None and last.shape[1]:
            last = torch.as_tensor(last, dtype=torch.float32).to(self.device)
            if last.shape[0] != self.B or last.shape[1] >= self.S:
                raise ValueError(f"last chunk {tuple(last.shape)}: expected ({self.B}, r), "
                                 f"r < {self.S}")
            self.tail = torch.cat([self.tail, last], dim=1)
            self.n_samples += last.shape[1]
        total = F.count_frames(self.n_samples, self.n_fft, self.shift)
        n_frames = total - self.n_mel
        if n_frames > 0:
            x = torch.nn.functional.pad(self.tail, (0, self.n_fft // 2))
            need = n_frames * self.shift + self.n_fft - self.shift
            if x.shape[1] < need:               # the last frame's window runs past the pad
                x = torch.nn.functional.pad(x, (0, need - x.shape[1]))
            mel = self._normalize(_logmel(x, n_frames, self.shift, self.window, self.mel))
            self.melbuf = torch.cat([self.melbuf, mel], dim=1)
            self.n_mel = total
        # frames past the end are zeros, as the offline splice pads them
        cat = torch.nn.functional.pad(self.melbuf, (0, 0, 0, self.c))
        off = self.n_mel - (cat.shape[1] - self.c)          # the frame at cat[:, 0]
        centers = np.arange(0, total, self.sub)[self.n_spliced:]
        src = centers[:, None] - self.c + np.arange(2 * self.c + 1)[None, :] - off
        ok = torch.as_tensor((src >= 0) & (src < cat.shape[1]), device=self.device)
        src = torch.as_tensor(np.clip(src, 0, cat.shape[1] - 1), device=self.device)
        feats = cat[:, src] * ok[None, :, :, None]           # (B, n, 2c+1, n_mels)
        self.n_spliced += len(centers)
        return feats.reshape(self.B, len(centers), (2 * self.c + 1) * self.n_mels)
