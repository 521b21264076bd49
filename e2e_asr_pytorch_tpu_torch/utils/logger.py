"""Experiment logging: stdout + TensorBoard.

Mirrors the reference solver's observability surface (reference:
src/solver.py:136-174): `verbose` padded [INFO] lines, `progress`
carriage-return status lines, and `write_log` routing by tag substring to
scalar/text/image/audio TensorBoard entries. Uses tensorboardX; degrades to
stdout-only if unavailable.
"""

from __future__ import annotations

import sys
from typing import Any, Optional

import numpy as np

try:
    from tensorboardX import SummaryWriter
except Exception:  # pragma: no cover - tensorboardX is normally present
    SummaryWriter = None


class Logger:
    def __init__(self, logdir: Optional[str], verbose: bool = True,
                 flush_secs: int = 180):
        self.verbose_on = verbose
        self.writer = None
        if logdir is not None and SummaryWriter is not None:
            self.writer = SummaryWriter(logdir, flush_secs=flush_secs)

    def verbose(self, msg):
        if not self.verbose_on:
            return
        if isinstance(msg, (list, tuple)):
            for m in msg:
                self.verbose(m)
        else:
            print("[INFO]", msg.ljust(100))

    def progress(self, msg):
        if not self.verbose_on:
            return
        sys.stdout.write("\033[K")  # clear line
        print("[{}]".format(msg.ljust(100)), end="\r")

    def write_log(self, log_name: str, log_dict: Any, step: int):
        """Route by tag substring like the reference: 'align'/'spec' ->
        image, 'text' -> text, 'wave' -> audio, else scalars."""
        if self.writer is None:
            return
        if type(log_dict) is dict:
            log_dict = {k: float(v) for k, v in log_dict.items()
                        if v is not None and not _is_nan(v)}
            if len(log_dict) == 0:
                return
        if "align" in log_name or "spec" in log_name:
            img, form = log_dict
            self.writer.add_image(log_name, np.asarray(img), global_step=step,
                                  dataformats=form)
        elif "text" in log_name or "hyp" in log_name:
            self.writer.add_text(log_name, str(log_dict), global_step=step)
        elif "wave" in log_name:
            wave, sr = log_dict
            self.writer.add_audio(log_name, np.asarray(wave), global_step=step,
                                  sample_rate=sr)
        else:
            self.writer.add_scalars(log_name, log_dict, step)

    def close(self):
        if self.writer is not None:
            self.writer.close()


def _is_nan(v) -> bool:
    try:
        return bool(np.isnan(float(v)))
    except (TypeError, ValueError):
        return False


def feat_to_fig(feat: np.ndarray):
    """Render a TxD matrix (attention map / spectrogram) to an HWC image
    array for TensorBoard, like reference src/util.py:91-112 (matplotlib
    figure when available; hand-rolled viridis-like colorize otherwise —
    rendering stays OFF the training hot path either way)."""
    feat = np.asarray(feat, dtype=np.float32)
    lo, hi = float(feat.min()), float(feat.max())
    norm = (feat - lo) / (hi - lo + 1e-8)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, ax = plt.subplots(figsize=(6, 3), dpi=100)
        ax.imshow(norm.T, aspect="auto", origin="lower", cmap="viridis")
        fig.tight_layout(pad=0.2)
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].astype(
            np.float32) / 255.0
        plt.close(fig)
        return img, "HWC"
    except Exception:
        pass
    # 3-stop colormap fallback: dark blue -> green -> yellow
    stops = np.array([[68, 1, 84], [33, 145, 140], [253, 231, 37]],
                     dtype=np.float32) / 255.0
    t = np.clip(norm * 2.0, 0.0, 2.0)
    lowseg = t < 1.0
    c = np.empty(feat.shape + (3,), dtype=np.float32)
    for ch in range(3):
        c[..., ch] = np.where(
            lowseg,
            stops[0, ch] + (stops[1, ch] - stops[0, ch]) * t,
            stops[1, ch] + (stops[2, ch] - stops[1, ch]) * (t - 1.0))
    return c, "HWC"
