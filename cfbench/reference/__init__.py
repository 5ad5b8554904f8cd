"""Plain PyTorch references of the benchmark's models, in float32 with TF32 off.

They follow the published models (FLUX.1-dev, HunyuanVideo-T2V and FLUX's
AutoencoderKL decoder) on weight trees in the port's layout: a linear's
weight is (d_in, d_out), rotary pairs are (i, i + D/2) ("rotate half"), a
latent token packs (2, 2, C).  They import neither JAX nor any part of the
package under test, and read only the weights and inputs the benchmark
draws from the seed.  ``precision.Precision("fp8")`` turns each into the
correctness check's control.
"""
