"""Cross-file continuous byte stream (reference I1).

Replicates ``read_continuous_file_stream.m``: reads of exactly N bytes are
spliced across sequentially-numbered ``.bin`` files; end-of-stream is
signalled when the next file cannot be opened or a read comes up short.

Unlike the reference's hidden ``persistent`` state machine (reset via
``clear``, SURVEY.md §5.2), the cursor here is an explicit object: position,
file index and open handle are plain attributes, so the state is inspectable,
resumable and trivially testable against randomized file-boundary placements.
"""

from __future__ import annotations

import os
from typing import Callable, Tuple


class FileStream:
    """Continuous reader over ``path_fn(root, index)`` for index = start, ...

    ``read(n)`` returns ``(data, eos)`` where ``len(data) <= n``; ``eos`` is
    True when the stream cannot supply more bytes (matching the reference's
    ``is_end_of_stream`` including the partial-read case,
    ``read_continuous_file_stream.m:163-166``).
    """

    def __init__(
        self,
        root: str,
        path_fn: Callable[[str, int], str],
        start_index: int = 1,
    ):
        self.root = root
        self.path_fn = path_fn
        self.file_index = start_index - 1
        self._fh = None
        self._remaining = 0

    def _open_next(self) -> bool:
        # commit the index only on success so a retry after transient EOS
        # re-attempts the same file instead of skipping ahead (the reference
        # advances unconditionally — read_continuous_file_stream.m:254 — which
        # silently defeats its own retry loop)
        nxt = self.file_index + 1
        path = self.path_fn(self.root, nxt)
        try:
            fh = open(path, "rb")
        except OSError:
            return False
        size = os.fstat(fh.fileno()).st_size
        self.file_index = nxt
        self._fh = fh
        self._remaining = size
        return True

    def read(self, n: int) -> Tuple[bytes, bool]:
        parts = []
        need = n
        while need > 0:
            if self._fh is None:
                if not self._open_next():
                    return b"".join(parts), True
            chunk = self._fh.read(min(need, self._remaining))
            got = len(chunk)
            parts.append(chunk)
            need -= got
            self._remaining -= got
            if self._remaining <= 0 or got == 0:
                self._fh.close()
                self._fh = None
                if got == 0 and self._remaining > 0:
                    # short read inside a file: premature end of stream
                    return b"".join(parts), True
        return b"".join(parts), False

    def close(self) -> None:
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
