"""IO layer tests: spectrum files, problem files, binary outputs round-trip,
checkpoint/resume bitwise determinism (SURVEY.md section 5.4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from tamcmc_tpu.io.data import read_spectrum, write_spectrum
from tamcmc_tpu.io.problemfile import (read_problem_file, write_problem_file,
                                       read_reference_model)
from tamcmc_tpu.io.outputs import OutputWriter, read_bin_samples
from tamcmc_tpu.io.checkpoint import save_checkpoint, load_checkpoint
from tamcmc_tpu.stats.priors import PriorTable, PriorKind


class TestSpectrumIO:
    def test_ascii_roundtrip(self, tmp_path):
        nu = np.linspace(1, 100, 64); pw = np.random.default_rng(0).exponential(2, 64)
        p = tmp_path / "s.data"
        write_spectrum(str(p), nu, pw)
        d = read_spectrum(str(p))
        np.testing.assert_allclose(d["nu"], nu, rtol=1e-10)
        np.testing.assert_allclose(d["power"], pw, rtol=1e-10)

    def test_npz_roundtrip_with_sigma(self, tmp_path):
        nu = np.linspace(1, 10, 8); pw = np.ones(8); sg = np.full(8, 0.1)
        p = tmp_path / "s.npz"
        write_spectrum(str(p), nu, pw, sigma=sg)
        d = read_spectrum(str(p))
        np.testing.assert_allclose(d["sigma"], sg)

    def test_comments_skipped(self, tmp_path):
        p = tmp_path / "c.data"
        p.write_text("# header\n! gnuplot comment\n1.0 2.0\n2.0 3.0\n")
        d = read_spectrum(str(p))
        assert d["nu"].tolist() == [1.0, 2.0]


class TestProblemFile:
    def test_roundtrip(self, tmp_path):
        priors = PriorTable.from_rows([
            ("H", "jeffreys", 0.5, 100.0),
            ("nu0", "uniform", 30.0, 70.0),
            ("W", "fix"),
            ("N0", "gaussian", 1.0, 0.2),
        ])
        p0 = np.asarray([8.0, 48.0, 3.0, 1.5])
        f = tmp_path / "prob.toml"
        write_problem_file(str(f), "model_Single_Lorentzian", p0, priors,
                           likelihood="chi22p", data="s.data",
                           freq_range=(10.0, 90.0))
        cfg = read_problem_file(str(f))
        assert cfg["model"] == "model_Single_Lorentzian"
        assert cfg["likelihood"] == "chi22p"
        assert cfg["freq_range"] == [10.0, 90.0]
        np.testing.assert_allclose(cfg["params0"], p0)
        np.testing.assert_array_equal(cfg["priors"].kinds, priors.kinds)
        np.testing.assert_allclose(cfg["priors"].hypers, priors.hypers)

    def test_spec_kwargs(self, tmp_path):
        f = tmp_path / "p.toml"
        f.write_text('[problem]\nmodel = "model_MS_Global_a1etaa3_HarveyLike"\n'
                     '[spec]\nn_per_l = [3, 3, 0, 0]\n')
        cfg = read_problem_file(str(f))
        assert cfg["spec_kwargs"]["n_per_l"] == (3, 3, 0, 0)

    def test_reference_format_raises_regrounding(self):
        with pytest.raises(NotImplementedError):
            read_reference_model("whatever.model")


class TestOutputs:
    def test_bin_hdr_roundtrip(self, tmp_path):
        w = OutputWriter(str(tmp_path), ["a", "b", "c"], n_temps=2, n_chains=4)
        rng = np.random.default_rng(0)
        chunks = []
        for _ in range(3):
            outs = {"theta0": rng.normal(size=(5, 4, 3)),
                    "logL": rng.normal(size=(5, 2, 4)),
                    "logP0": rng.normal(size=(5, 4)),
                    "log_sigma": rng.normal(size=(5, 2)),
                    "acc_rate": rng.uniform(size=(5, 2)),
                    "mu0": rng.normal(size=(5, 3))}
            chunks.append(outs)
            w.append_chunk("A", outs)
        w.close()
        samples, names = read_bin_samples(str(tmp_path), "A")
        assert names == ["a", "b", "c"]
        want = np.concatenate([c["theta0"].reshape(20, 3) for c in chunks])
        np.testing.assert_allclose(samples, want, rtol=1e-12)
        z = np.load(tmp_path / "A_chains.npz")
        assert z["logL"].shape == (15, 2, 4)


    def test_resume_drops_chain_records_past_the_checkpoint(self, tmp_path):
        """A crash after save_partial but before the checkpoint leaves
        chain records past it; the resumed phase keeps the checkpointed
        emits only, so samples and chain arrays stay aligned."""
        rng = np.random.default_rng(1)

        def chunk(E):
            return {"theta0": rng.normal(size=(E, 4, 3)),
                    "logL": rng.normal(size=(E, 2, 4))}

        w = OutputWriter(str(tmp_path), ["a", "b", "c"], n_temps=2,
                         n_chains=4)
        w.append_chunk("A", chunk(2))
        w.save_partial("A")             # checkpoint taken here: 2 emits
        w.append_chunk("A", chunk(2))
        w.save_partial("A")             # ... crash before its checkpoint
        w.abort()
        w2 = OutputWriter(str(tmp_path), ["a", "b", "c"], n_temps=2,
                          n_chains=4)
        w2.resume_phase("A", 2 * 4)
        w2.append_chunk("A", chunk(1))
        w2.close()
        samples, _ = read_bin_samples(str(tmp_path), "A")
        z = np.load(tmp_path / "A_chains.npz")
        assert samples.shape[0] == 3 * 4
        assert z["logL"].shape == (3, 2, 4)


class TestCheckpoint:
    def test_roundtrip_and_bitwise_resume(self, tmp_path):
        from tamcmc_tpu.sampler import (init_state, MALAHyper, mala_step,
                                        make_beta_ladder)
        from tamcmc_tpu.sampler.analytic import std_gaussian
        p = std_gaussian(3)
        hp = MALAHyper(use_drift=False)
        betas = make_beta_ladder(2, hp.lambda_temp)
        key = jax.random.PRNGKey(0)
        s = init_state(p, hp, 2, 4, key)
        s = mala_step(p, hp, betas, s, jax.random.PRNGKey(1))
        ck = tmp_path / "restore.npz"
        save_checkpoint(str(ck), s, jax.random.PRNGKey(2), phase="L",
                        meta={"n_steps": 100})
        s2, key2, phase, meta = load_checkpoint(str(ck))
        assert phase == "L"
        assert int(meta["n_steps"]) == 100
        np.testing.assert_array_equal(np.asarray(s.theta), np.asarray(s2.theta))
        np.testing.assert_array_equal(np.asarray(s.cov), np.asarray(s2.cov))
        # bitwise-deterministic continuation from restored state
        a = mala_step(p, hp, betas, s, key2)
        b = mala_step(p, hp, betas, s2, key2)
        np.testing.assert_array_equal(np.asarray(a.theta), np.asarray(b.theta))
        np.testing.assert_array_equal(np.asarray(a.logL), np.asarray(b.logL))


class TestExportThinning:
    def test_thin_strides_emits_not_flat_records(self, tmp_path, capsys):
        """`tamcmc export --thin k` must take every k-th EMIT (all walkers of
        it), like the reference's bin2txt thinning records of a chain [U] —
        NOT every k-th row of the (emit x walker)-interleaved flat array
        (round-3 VERDICT weak #4: k not a multiple of Nchains then takes an
        uneven walker subset per emit)."""
        C, Df, E = 4, 3, 10
        w = OutputWriter(str(tmp_path), ["a", "b", "c"], n_temps=2, n_chains=C)
        # encode identity: theta0[e, c, d] = 100*e + 10*c + d
        e_i, c_i, d_i = np.meshgrid(np.arange(E), np.arange(C), np.arange(Df),
                                    indexing="ij")
        theta0 = (100 * e_i + 10 * c_i + d_i).astype(float)
        w.append_chunk("A", {"theta0": theta0,
                             "logL": np.zeros((E, 2, C)),
                             "logP0": np.zeros((E, C)),
                             "log_sigma": np.zeros((E, 2)),
                             "acc_rate": np.zeros((E, 2)),
                             "mu0": np.zeros((E, Df))})
        w.close()
        from tamcmc_tpu.cli import main
        main(["export", "--outdir", str(tmp_path), "--phase", "A",
              "--thin", "3"])          # 3 is NOT a multiple of C=4
        txt = np.loadtxt(tmp_path / "A_samples.txt")
        # emits 0, 3, 6, 9 -> 4 emits x 4 walkers
        assert txt.shape == (16, Df)
        got_emits = np.unique(txt[:, 0] // 100).astype(int)
        np.testing.assert_array_equal(got_emits, [0, 3, 6, 9])
        # every selected emit carries ALL its walkers
        for e in got_emits:
            rows = txt[txt[:, 0] // 100 == e]
            np.testing.assert_array_equal(np.sort(rows[:, 0] % 100 // 10),
                                          np.arange(C))

    def test_range_selects_emits(self, tmp_path, capsys):
        C, Df, E = 2, 2, 6
        w = OutputWriter(str(tmp_path), ["a", "b"], n_temps=2, n_chains=C)
        theta0 = np.arange(E)[:, None, None] * np.ones((E, C, Df))
        w.append_chunk("A", {"theta0": theta0,
                             "logL": np.zeros((E, 2, C)),
                             "logP0": np.zeros((E, C)),
                             "log_sigma": np.zeros((E, 2)),
                             "acc_rate": np.zeros((E, 2)),
                             "mu0": np.zeros((E, Df))})
        w.close()
        from tamcmc_tpu.cli import main
        main(["export", "--outdir", str(tmp_path), "--phase", "A",
              "--range", "2:4"])
        txt = np.loadtxt(tmp_path / "A_samples.txt")
        assert txt.shape == (2 * C, Df)
        np.testing.assert_array_equal(np.unique(txt[:, 0]), [2, 3])


class TestCheckpointSchema:
    def _make_state(self):
        from tamcmc_tpu.sampler import (init_state, MALAHyper,
                                        make_beta_ladder)
        from tamcmc_tpu.sampler.analytic import std_gaussian
        p = std_gaussian(2)
        hp = MALAHyper(use_drift=False)
        return init_state(p, hp, 2, 2, jax.random.PRNGKey(0))

    def test_version_written_and_roundtrips(self, tmp_path):
        from tamcmc_tpu.io.checkpoint import SCHEMA_VERSION
        ck = tmp_path / "r.npz"
        save_checkpoint(str(ck), self._make_state(), jax.random.PRNGKey(1))
        z = np.load(ck)
        assert int(z["schema_version"]) == SCHEMA_VERSION
        load_checkpoint(str(ck))    # no raise

    def test_mismatched_version_refused_loudly(self, tmp_path):
        ck = tmp_path / "r.npz"
        save_checkpoint(str(ck), self._make_state(), jax.random.PRNGKey(1))
        z = dict(np.load(ck))
        z["schema_version"] = np.asarray(999)
        np.savez(ck, **z)
        with pytest.raises(ValueError, match="schema v999"):
            load_checkpoint(str(ck))

    def test_legacy_unversioned_grandfathered_when_complete(self, tmp_path,
                                                            capsys):
        """Pre-versioning checkpoints whose payload fully validates load
        with a loud note (the gate stops misloads, it does not strand
        in-flight fits across the upgrade)."""
        ck = tmp_path / "r.npz"
        save_checkpoint(str(ck), self._make_state(), jax.random.PRNGKey(1))
        z = dict(np.load(ck))
        del z["schema_version"]
        np.savez(ck, **z)
        load_checkpoint(str(ck))        # no raise
        assert "predates schema versioning" in capsys.readouterr().err

    def test_legacy_unversioned_incomplete_refused(self, tmp_path):
        ck = tmp_path / "r.npz"
        save_checkpoint(str(ck), self._make_state(), jax.random.PRNGKey(1))
        z = dict(np.load(ck))
        del z["schema_version"]
        del z["state_cov"]
        np.savez(ck, **z)
        # an unversioned AND incomplete payload is refused (reported as a
        # version mismatch: only a fully-validating v0 is grandfathered)
        with pytest.raises(ValueError, match="schema v0"):
            load_checkpoint(str(ck))

    def test_missing_field_refused(self, tmp_path):
        ck = tmp_path / "r.npz"
        save_checkpoint(str(ck), self._make_state(), jax.random.PRNGKey(1))
        z = dict(np.load(ck))
        del z["state_theta"]
        np.savez(ck, **z)
        with pytest.raises(ValueError, match="missing state fields"):
            load_checkpoint(str(ck))
