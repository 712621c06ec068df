"""G2 frames as ``.bin`` packets in ``TMPDIR``, one directory a frame,
written by the benchmark's frozen packet writer and parsed again from its
file by the port's reader at every handover; no parse is cached.  The check
compares the parsed samples of the kept handovers with the generated
frames."""

from __future__ import annotations

import atexit
import shutil
import tempfile

from benchmark.packets import write_g2_frame


class Store:
    def __init__(self, sut):
        from radar_signal_process_tpu_torch.ingest import g2_reader_class

        self.sut = sut
        self.tmp = tempfile.mkdtemp(prefix="g2_packets_")
        atexit.register(shutil.rmtree, self.tmp, True)   # also when the run fails
        self.dirs = []
        for j, iq in enumerate(sut.frames):
            d = f"{self.tmp}/frame{j}"
            write_g2_frame(d, iq, sut.config["profile"], j)
            self.dirs.append(d)
        self.reader_cls = g2_reader_class()
        self.parsed: dict = {}

    def get(self, idx: int):
        reader = self.reader_cls(self.dirs[idx % len(self.dirs)], self.sut.profile)
        try:
            res = reader.read_frame(0)
        finally:
            close = getattr(reader, "close", None)
            if close is not None:
                close()
        # the last few parses, for the check to take
        self.parsed[idx] = res.iq
        self.parsed.pop(idx - 8, None)
        return res

    def take(self, idx: int):
        return self.parsed.get(idx)

    def check(self, kept: dict) -> dict:
        bad = 0
        for idx, parsed in kept.values():
            want = self.sut.frames[idx % len(self.sut.frames)]
            bad += want.size if parsed is None else int((parsed != want).sum())
        return {"parsed_differ": (bad, 0)}

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)
