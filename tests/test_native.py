"""Native C++ IO runtime tests (skipped when no compiler/lib available)."""
import os
import pathlib
import shutil

import numpy as np
import pytest

from tamcmc_tpu.io.native import available, NativeRecordWriter, native_read_table


pytestmark = pytest.mark.skipif(not available(),
                                reason="native recordio not built")


class TestNativeWriter:
    def test_exact_roundtrip(self, tmp_path):
        p = tmp_path / "x.bin"
        w = NativeRecordWriter(str(p), 3)
        rng = np.random.default_rng(1)
        blocks = [rng.normal(size=(257, 3)) for _ in range(7)]
        for b in blocks:
            w.append(b)
        assert w.count == 7 * 257
        w.close()
        back = np.fromfile(p).reshape(-1, 3)
        np.testing.assert_array_equal(back, np.concatenate(blocks))

    def test_outputwriter_uses_native(self, tmp_path):
        from tamcmc_tpu.io.outputs import OutputWriter, read_bin_samples
        w = OutputWriter(str(tmp_path), ["a", "b"], 2, 3)
        outs = {"theta0": np.arange(18.0).reshape(3, 3, 2),
                "logL": np.zeros((3, 2, 3)), "logP0": np.zeros((3, 3)),
                "log_sigma": np.zeros((3, 2)), "acc_rate": np.zeros((3, 2)),
                "mu0": np.zeros((3, 2))}
        assert hasattr(w._open_writer("probe", 2), "append")  # native chosen
        w.append_chunk("A", outs)
        w.close()
        samples, names = read_bin_samples(str(tmp_path), "A")
        np.testing.assert_array_equal(samples, np.arange(18.0).reshape(9, 2))


class TestNativeAsciiReader:
    def test_matches_loadtxt_with_comments(self, tmp_path):
        p = tmp_path / "t.data"
        p.write_text("# c\n! gnuplot\n1 2.5\n3 4.5e-2\n")
        t = native_read_table(str(p))
        np.testing.assert_allclose(t, [[1, 2.5], [3, 0.045]])

    def test_ragged_raises(self, tmp_path):
        p = tmp_path / "r.data"
        p.write_text("1 2\n3 4 5\n")
        with pytest.raises(OSError):
            native_read_table(str(p))

    def test_spectrum_reader_integration(self, tmp_path):
        from tamcmc_tpu.io.data import read_spectrum, write_spectrum
        nu = np.linspace(0, 9, 10); pw = np.arange(10.0)
        write_spectrum(str(tmp_path / "s.data"), nu, pw)
        d = read_spectrum(str(tmp_path / "s.data"))
        np.testing.assert_allclose(d["nu"], nu, rtol=1e-12)


class TestNativeBuild:
    def test_load_rebuilds_a_stale_library(self, tmp_path, monkeypatch):
        """_load always runs make: a library older than recordio.cpp is
        rebuilt from the source, never loaded as it is."""
        from tamcmc_tpu.io import native
        src = pathlib.Path(native.__file__).resolve().parents[2] / "native"
        for f in ("Makefile", "recordio.cpp"):
            shutil.copy(src / f, tmp_path / f)
        lib = tmp_path / "librecordio.so"
        monkeypatch.setattr(native, "_NATIVE_DIR", tmp_path)
        monkeypatch.setattr(native, "_LIB_PATH", lib)

        def load():
            monkeypatch.setattr(native, "_lib", None)
            monkeypatch.setattr(native, "_tried", False)
            return native._load()

        assert load() is not None
        first = lib.stat().st_mtime_ns
        # the source is edited after that build: the next load rebuilds
        later = first + 5_000_000_000
        os.utime(tmp_path / "recordio.cpp", ns=(later, later))
        assert load() is not None
        assert lib.stat().st_mtime_ns > first
