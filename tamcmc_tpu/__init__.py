"""tamcmc_tpu — asteroseismic peak-bagging MCMC engine in JAX, for NVIDIA GPUs.

A ground-up JAX/XLA rebuild of the capabilities of the C++ reference
OthmanB/TAMCMC-C- (adaptive truncated-drift MALA + parallel tempering over
Lorentzian-mode + Harvey-noise power-spectrum models with a chi^2(2 d.o.f.)
spectral likelihood).  See SURVEY.md at the repo root for the layer map this
package implements and for the provenance caveats on reference citations.

Layout (mirrors SURVEY.md section 1's layers, redesigned as batched array programs for XLA):
  ops/         L1 spectrum-model kernels (Lorentzian, rotation, noise, Alm, ARMM)
  models/      L2 model library (registry of pure jnp model functions)
  stats/       L3 likelihoods and prior tables
  io/          L4+L6 problem setup, config, outputs, checkpointing
  sampler/     L5 adaptive MALA + parallel tempering (lax.scan core)
  parallel/    mesh/shard_map scale-out (the rebuild's "distributed backend")
  diagnostics/ ESS, reports, trace plots
  tools/       bin2txt / getmodel / stats equivalents (CLI subcommands)
"""

__version__ = "0.1.0"
