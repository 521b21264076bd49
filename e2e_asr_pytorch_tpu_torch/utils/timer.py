"""Step-time profiler.

Same observable behavior as the reference's Timer (reference:
src/util.py:30-57): accumulate wall time into read/forward/backward buckets
and report "sec/step (rd%|fw%|bw%)". The solvers stamp 'rd' for the host's
batch read and 'fw' for the device step, which they end with a device sync
on CUDA; profiler traces are the solvers' ``--profile`` flag. The port's
step is forward, backward and update in one stamp, so a step is counted on
'fw' (the reference counts on 'bw', which the port's solvers never stamp).
"""

import time


class Timer:
    def __init__(self):
        self.prev_t = time.time()
        self.clear()

    def set(self):
        self.prev_t = time.time()

    def cnt(self, mode):
        self.time_table[mode] += time.time() - self.prev_t
        self.set()
        if mode == "fw":
            self.click += 1

    def show(self):
        total = sum(self.time_table.values())
        clicks = max(self.click, 1)
        msg = "{:.3f} sec/step (rd {:.1f}% | fw {:.1f}% | bw {:.1f}%)".format(
            total / clicks,
            100 * self.time_table["rd"] / total if total else 0.0,
            100 * self.time_table["fw"] / total if total else 0.0,
            100 * self.time_table["bw"] / total if total else 0.0,
        )
        self.clear()
        return msg

    def clear(self):
        self.time_table = {"rd": 0.0, "fw": 0.0, "bw": 0.0}
        self.click = 0


def human_format(num):
    magnitude = 0
    while num >= 1000:
        magnitude += 1
        num /= 1000.0
    return "{:3.1f}{}".format(num, [" ", "K", "M", "G", "T", "P"][magnitude])
