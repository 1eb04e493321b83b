"""Native C++ library: builds with the in-image toolchain and matches the
pure-Python implementations bit-for-bit."""

import numpy as np
import pytest

from ljmd_tpu.utils import native
from ljmd_tpu.utils.ran3 import Ran3


@pytest.fixture(scope="module")
def lib():
    if not native.ensure_built():
        pytest.skip("native toolchain unavailable")
    lib = native.load()
    if lib is None:
        pytest.skip("native library failed to load")
    return lib


def test_native_ran3_matches_python(lib):
    for seed in (-12345, -1, 7, 999999):
        got = native.ran3_fill(seed, 500)
        want = Ran3(seed).uniform(500)
        np.testing.assert_array_equal(got, want)


def test_native_rva_roundtrip(lib, tmp_path):
    rng = np.random.default_rng(0)
    n_snap, n = 4, 10
    frames = {k: rng.normal(size=(n_snap, n, 3)) for k in ("r", "ru", "v", "a")}
    p = str(tmp_path / "rva_native.dat")
    native.write_rva_native(p, 7.25, 0.002, 50, frames["r"], frames["ru"], frames["v"], frames["a"])
    data = native.read_rva_native(p)
    assert data.n == n and data.n_snapshots == n_snap
    assert data.box_length == pytest.approx(7.25)
    for k in ("r", "ru", "v", "a"):
        np.testing.assert_array_equal(getattr(data, k), frames[k])


def test_native_file_readable_by_python_codec(lib, tmp_path):
    from ljmd_tpu.io.fortran_records import read_rva, write_rva

    rng = np.random.default_rng(1)
    frames = {k: rng.normal(size=(3, 6, 3)) for k in ("r", "ru", "v", "a")}
    p1 = str(tmp_path / "native.dat")
    native.write_rva_native(p1, 5.0, 0.001, 10, frames["r"], frames["ru"], frames["v"], frames["a"])
    d1 = read_rva(p1)  # python codec reads native-written file
    np.testing.assert_array_equal(d1.v, frames["v"])

    p2 = str(tmp_path / "python.dat")
    write_rva(p2, 5.0, 0.001, 10, frames["r"], frames["ru"], frames["v"], frames["a"])
    d2 = native.read_rva_native(p2)  # native codec reads python-written file
    np.testing.assert_array_equal(d2.a, frames["a"])
    # byte-identical outputs
    assert open(p1, "rb").read() == open(p2, "rb").read()


def test_async_writer_matches_sync_writer(tmp_path):
    """AsyncTrajectoryWriter produces byte-identical rva.dat to the Python
    TrajectoryWriter, including the patched header and the append/resume
    path."""
    import numpy as np

    from ljmd_tpu.io.fortran_records import read_rva
    from ljmd_tpu.io.trajectory import AsyncTrajectoryWriter, TrajectoryWriter
    from ljmd_tpu.utils import native

    rng = np.random.default_rng(0)
    n, frames = 40, 7
    blocks = [rng.normal(size=(k, n, 3)) for k in (3, 4)]
    args = (n, 8.5, 0.002, 10)

    p_sync = str(tmp_path / "sync.dat")
    w = TrajectoryWriter(p_sync, *args, n_snapshots_expected=frames)
    for b in blocks:
        w.append(b, b + 1, b + 2, b + 3)
    w.close()

    p_async = str(tmp_path / "async.dat")
    w = AsyncTrajectoryWriter(p_async, *args, n_snapshots_expected=frames)
    assert (w._fallback is None) == native.available()
    w.append(blocks[0], blocks[0] + 1, blocks[0] + 2, blocks[0] + 3)
    w.close()
    # resume-style append of the second block
    w = AsyncTrajectoryWriter.open_for_append(p_async, *args, frames_present=3)
    w.append(blocks[1], blocks[1] + 1, blocks[1] + 2, blocks[1] + 3)
    w.close()

    assert open(p_sync, "rb").read() == open(p_async, "rb").read()
    data = read_rva(p_async)
    assert data.r.shape == (frames, n, 3)
    np.testing.assert_allclose(data.v[3:], blocks[1] + 2)


def test_writer_append_truncates_torn_frames(tmp_path):
    """A kill during a later chunk's write can leave rva.dat with extra or
    TORN frame records past the checkpointed count (an N=62500
    kill-and-resume run: the resumed file carried a partial frame and
    diverged from the uninterrupted run). open_for_append must truncate to
    the checkpoint's frame count; a file SHORTER than the checkpoint claims
    (pre-sync-fence write ordering) must be rejected loudly."""
    import numpy as np
    import pytest

    from ljmd_tpu.io.fortran_records import read_rva
    from ljmd_tpu.io.trajectory import AsyncTrajectoryWriter, TrajectoryWriter

    rng = np.random.default_rng(1)
    n = 16
    args = (n, 5.0, 0.001, 4)
    b1 = rng.normal(size=(2, n, 3))
    b2 = rng.normal(size=(2, n, 3))

    for cls in (TrajectoryWriter, AsyncTrajectoryWriter):
        p = str(tmp_path / f"{cls.__name__}.dat")
        w = cls(p, *args, n_snapshots_expected=4)
        w.append(b1, b1, b1, b1)
        if hasattr(w, "sync"):
            w.sync()
        w.close()
        good = open(p, "rb").read()
        # torn write past the checkpointed 2 frames: half a frame of garbage
        with open(p, "ab") as f:
            f.write(b"\x7f" * ((4 + 24 * n + 4) * 2 + 13))
        w = cls.open_for_append(p, *args, frames_present=2)
        assert open(p, "rb").read() == good  # extras dropped
        w.append(b2, b2, b2, b2)
        w.close()
        data = read_rva(p)
        assert data.r.shape == (4, n, 3)
        np.testing.assert_allclose(data.a[2:], b2)

        # file shorter than the checkpoint claims -> loud failure, not a
        # silently corrupt resume
        with open(p, "r+b") as f:
            f.truncate(100)
        with pytest.raises(ValueError, match="cannot be resumed"):
            cls.open_for_append(p, *args, frames_present=2)
