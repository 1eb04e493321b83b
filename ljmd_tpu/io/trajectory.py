"""Incremental trajectory writer (the rva.dat streaming contract).

The reference writes every sampled frame to disk immediately inside the MD
loop (md_simulation_program.f90:384-387) — that is how it "streams" long
trajectories. This writer reproduces that: an open rva.dat receiving frame
records as sampled blocks arrive from device, so arbitrarily long runs never
hold the trajectory in memory (SURVEY §5.7 time-axis scaling). The file is
bit-compatible with the Fortran format and with ``io/fortran_records.read_rva``.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from ljmd_tpu.io.fortran_records import _HEADER_FMT, _xyz_to_record, write_record

__all__ = ["AsyncTrajectoryWriter", "TrajectoryWriter"]


def _truncate_to_frames(path: str, n: int, frames_present: int) -> None:
    """Cut an rva.dat to header + ``frames_present`` whole frames. A crash
    between a checkpoint and a later chunk's (possibly in-flight) frame
    write leaves the file longer than the checkpoint's frame count — or
    torn mid-record; resume must drop those bytes or the appended frames
    land after garbage. Record layout per frame: 4 records (r, ru, v, a) of
    4-byte marker + 3n float64 + 4-byte marker."""
    header_bytes = 4 + struct.calcsize(_HEADER_FMT) + 4
    frame_bytes = 4 * (4 + 24 * n + 4)
    want = header_bytes + frames_present * frame_bytes
    have = os.path.getsize(path)
    if have < want:
        raise ValueError(
            f"rva.dat at {path} holds {have} bytes but the checkpoint claims "
            f"{frames_present} frames ({want} bytes) — the file cannot be "
            "resumed (was it written without the pre-checkpoint sync fence?)"
        )
    if have > want:
        os.truncate(path, want)


class TrajectoryWriter:
    """Append-oriented rva.dat writer.

    The header's snapshot count is written up front (the reference computes
    the expected count before the loop, md_simulation_program.f90:254) and
    patched on close with the actual count, so truncated runs remain
    readable.
    """

    def __init__(
        self,
        path: str,
        n: int,
        box_length: float,
        dt: float,
        output_interval: int,
        n_snapshots_expected: int,
    ):
        self.path = path
        self.n = n
        self._frames_written = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "wb")
        self._header_args = (n, float(box_length), float(dt), int(output_interval))
        write_record(
            self._f,
            struct.pack(_HEADER_FMT, *self._header_args, int(n_snapshots_expected)),
        )

    def append(self, r, ru, v, a) -> None:
        """Append a block of frames; each array (n_frames, N, 3) or (N, 3)."""
        arrs = [np.asarray(x, dtype=np.float64) for x in (r, ru, v, a)]
        if arrs[0].ndim == 2:
            arrs = [x[None] for x in arrs]
        n_frames = arrs[0].shape[0]
        for s in range(n_frames):
            for frames in arrs:
                write_record(self._f, _xyz_to_record(frames[s]))
        self._frames_written += n_frames
        self._f.flush()

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def sync(self) -> None:
        """Crash-consistency fence: frames flushed AND fsynced. The streaming
        driver calls this before each checkpoint so the checkpoint never
        claims more frames than the file durably holds."""
        self._f.flush()
        os.fsync(self._f.fileno())

    @classmethod
    def open_for_append(
        cls,
        path: str,
        n: int,
        box_length: float,
        dt: float,
        output_interval: int,
        frames_present: int,
    ) -> "TrajectoryWriter":
        """Reopen an existing (partially written) rva.dat to append more
        frames — the resume path of the streaming driver. The caller supplies
        the number of frames already on disk (from its checkpoint); the file
        is TRUNCATED to exactly that many frames first (a kill during a later
        chunk's write can leave extra or partial frame records past the
        checkpointed count — an N=62500 kill-and-resume run's resumed
        rva.dat once carried a torn frame);
        ``close()`` patches the header with the final total as usual."""
        _truncate_to_frames(path, n, frames_present)
        self = cls.__new__(cls)
        self.path = path
        self.n = n
        self._frames_written = frames_present
        self._header_args = (n, float(box_length), float(dt), int(output_interval))
        self._f = open(path, "r+b")
        self._f.seek(0, os.SEEK_END)
        return self

    def close(self) -> None:
        if self._f.closed:
            return
        # Patch the header with the actual frame count.
        self._f.flush()
        self._f.seek(4)  # skip leading record marker
        self._f.write(struct.pack(_HEADER_FMT, *self._header_args, self._frames_written))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class AsyncTrajectoryWriter:
    """rva.dat writer backed by the native C++ worker thread
    (native/ljmd_native.cpp ljmd_rva_async_*): ``append`` enqueues the frame
    block and returns immediately, so the device never waits for disk; the
    header is patched with the actual frame count on close. Falls back to
    the synchronous Python ``TrajectoryWriter`` when the native library is
    unavailable. Same interface as TrajectoryWriter."""

    def __init__(
        self,
        path: str,
        n: int,
        box_length: float,
        dt: float,
        output_interval: int,
        n_snapshots_expected: int,
    ):
        from ljmd_tpu.utils import native

        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.path = path
        self.n = n
        self._meta = (float(box_length), float(dt), int(output_interval))
        self._frames_written = 0
        self._handle = native.async_writer_open(
            path, n, box_length, dt, output_interval, n_snapshots_expected
        )
        self._fallback = None
        if self._handle is None:
            self._fallback = TrajectoryWriter(
                path, n, box_length, dt, output_interval, n_snapshots_expected
            )

    @classmethod
    def open_for_append(cls, path, n, box_length, dt, output_interval,
                        frames_present) -> "AsyncTrajectoryWriter":
        from ljmd_tpu.utils import native

        _truncate_to_frames(path, n, frames_present)
        self = cls.__new__(cls)
        self.path = path
        self.n = n
        self._meta = (float(box_length), float(dt), int(output_interval))
        self._frames_written = frames_present
        self._handle = native.async_writer_open(
            path, n, box_length, dt, output_interval, 0,
            append=True, frames_present=frames_present,
        )
        self._fallback = None
        if self._handle is None:
            self._fallback = TrajectoryWriter.open_for_append(
                path, n, box_length, dt, output_interval, frames_present
            )
        return self

    def sync(self) -> None:
        """Crash-consistency fence (see TrajectoryWriter.sync): drain the
        native queue, fflush, fsync. Falls back to a full close/reopen when
        an old .so without ljmd_rva_async_sync is loaded."""
        from ljmd_tpu.utils import native

        if self._fallback is not None:
            self._fallback.sync()
            return
        try:
            native.async_writer_sync(self._handle)
        except RuntimeError:
            # pre-round-5 .so: close (which drains) and reopen for append
            box_length, dt, output_interval = self._meta
            native.async_writer_close(self._handle)
            self._handle = native.async_writer_open(
                self.path, self.n, box_length, dt, output_interval, 0,
                append=True, frames_present=self._frames_written,
            )

    def append(self, r, ru, v, a) -> None:
        from ljmd_tpu.utils import native

        if self._fallback is not None:
            self._fallback.append(r, ru, v, a)
            self._frames_written = self._fallback.frames_written
            return
        arrs = [np.asarray(x, dtype=np.float64) for x in (r, ru, v, a)]
        n_frames = 1 if arrs[0].ndim == 2 else arrs[0].shape[0]
        native.async_writer_append(self._handle, *arrs)
        self._frames_written += n_frames

    @property
    def frames_written(self) -> int:
        return self._frames_written

    def close(self) -> None:
        from ljmd_tpu.utils import native

        if self._fallback is not None:
            self._fallback.close()
            return
        if self._handle is not None:
            native.async_writer_close(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
