"""Raw-audio streaming serving: 8 kHz samples in, speaker probabilities
out, with both the feature front end and the model on the card.

Port of `fseend_tpu/serving/raw_audio.py`.  It composes two device stages:

  StreamingLogmel      (ops/features_tpu.py)  raw samples -> spliced log-mel,
                                              carried STFT / norm / splice state
  BlockStreamingServer (serving/runtime.py)   K-frame blocks -> probabilities,
                                              carried retention / KV state

The features stay on the device: the host moves audio in and re-batches the
featurizer's ragged early output (the splice look-ahead makes the first
block short by `context_size` STFT frames) into the model's fixed K-frame
blocks with a `torch.cat` on the device.  Concatenating every return gives
the offline host pipeline (`ops/features.extract_fbank`) followed by the
batch pass over the stream's frames.
"""

from __future__ import annotations

import numpy as np
import torch

from fseend_tpu_torch.ops.features_tpu import StreamingLogmel


class RawAudioPipeline:
    """End-to-end streaming diarization over raw audio blocks.

    server: a `BlockStreamingServer` (LS or FS).  Feed fixed-size audio
    blocks through process_audio() and call flush() once at the end of the
    stream.  Every call returns the newly final probabilities (n_lanes,
    n_new, n_slots - 1) on the server's device; concatenating all returns
    gives the offline batch output over the stream's T spliced frames."""

    def __init__(self, server, *, frame_size: int = 200, frame_shift: int = 80,
                 context_size: int = 7, subsampling: int = 10,
                 input_transform: str = "logmel23", sr: int = 8000, n_mels: int = 23,
                 audio_block_samples: int | None = None):
        if audio_block_samples is None:
            # one model block's worth of samples per audio block
            audio_block_samples = server.block * frame_shift * subsampling
        self.srv = server
        self.K = server.block
        self.fe = StreamingLogmel(
            server.n_lanes, audio_block_samples, frame_size=frame_size,
            frame_shift=frame_shift, context_size=context_size, subsampling=subsampling,
            input_transform=input_transform, sr=sr, n_mels=n_mels, device=server.device)
        self.feat_dim = (2 * context_size + 1) * n_mels
        self._buf = self._zeros(0)
        self._fed = 0       # model blocks fed to the server
        self._T = 0         # spliced frames produced by the featurizer
        self._done = False

    @property
    def audio_block_samples(self) -> int:
        return self.fe.S

    def _zeros(self, frames: int) -> torch.Tensor:
        return torch.zeros(self.srv.n_lanes, frames, self.feat_dim, device=self.srv.device)

    def _take(self, feats: torch.Tensor) -> None:
        self._T += feats.shape[1]
        self._buf = torch.cat([self._buf, feats], dim=1)

    def _feed_full_blocks(self) -> list:
        outs = []
        while self._buf.shape[1] >= self.K:
            blk, self._buf = self._buf[:, :self.K], self._buf[:, self.K:]
            probs = self.srv.process_block(blk)
            self._fed += 1
            if self._fed > 1:     # the first call emits warm-up garbage
                outs.append(probs)
        return outs

    def _cat(self, outs: list) -> torch.Tensor:
        if outs:
            return torch.cat(outs, dim=1)
        return torch.zeros(self.srv.n_lanes, 0, self.srv.n_slots - 1, device=self.srv.device)

    def process_audio(self, audio) -> torch.Tensor:
        """audio (n_lanes, audio_block_samples) -> the newly final
        probabilities (n_lanes, n_new, n_slots - 1); n_new varies with the
        pipeline's fill."""
        if self._done:
            raise RuntimeError("stream already flushed; build a new pipeline")
        self._take(self.fe.process_block(audio))
        return self._cat(self._feed_full_blocks())

    def flush(self, last_audio=None) -> torch.Tensor:
        """End of stream: drain the featurizer (offline right-pad
        semantics), the final partial model block (zero-padded, with
        h_mask, for parity with the batch pass's re-pad) and the one-block
        emission lag.  last_audio: optional ragged final samples (n_lanes,
        r), r < audio_block_samples."""
        if self._done:
            raise RuntimeError("stream already flushed; build a new pipeline")
        self._done = True
        self._take(self.fe.flush(last_audio))
        outs = self._feed_full_blocks()
        valid = self._buf.shape[1]
        if valid:
            blk = torch.cat([self._buf, self._zeros(self.K - valid)], dim=1)
            probs = self.srv.process_block(blk, h_mask=np.arange(self.K) < valid)
            self._fed += 1
            if self._fed > 1:
                outs.append(probs)
            self._buf = self._buf[:, :0]
        if self._fed:
            # drain the one-block lag with a zero-embedding flush block
            outs.append(self.srv.process_block(self._zeros(self.K), flush=True))
        out = self._cat(outs)
        # lifetime emissions = _fed * K frames covering blocks 0..m-1; the
        # excess over T is the final block's zero padding, all at the end
        excess = self._fed * self.K - self._T
        return out[:, :out.shape[1] - excess] if excess else out


def stream_audio_file(server, audio: np.ndarray, **feat_kw) -> np.ndarray:
    """One recording's raw samples (n_samples,) through a fresh pipeline on
    every lane -> lane 0's (T, n_slots - 1) probabilities, equal to the
    offline extract_fbank + batch pass."""
    pipe = RawAudioPipeline(server, **feat_kw)
    S = pipe.audio_block_samples
    n = len(audio)
    xs = torch.as_tensor(np.asarray(audio, np.float32)).to(server.device)
    xs = xs[None].expand(server.n_lanes, n)
    outs = [pipe.process_audio(xs[:, st:st + S]) for st in range(0, n - n % S, S)]
    outs.append(pipe.flush(xs[:, n - n % S:] if n % S else None))
    return torch.cat([o[0] for o in outs], dim=0).cpu().numpy()
