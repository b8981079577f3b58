"""FHE-ML bridge, the port of `repro.fhe_ml`: post-training quantization
of model-zoo blocks, lowering to the FHE IR, and the plaintext oracle;
encrypted execution runs through `repro_torch.api.Session`, so on the
card every bootstrap goes through the port's kernels.

Two activation representations:

  narrow-LUT  `QuantSpec` affine activations in one width-bit ciphertext,
              requant PBS per layer (`lower_mlp`, `lower_gpt2_block`).
  radix       `RadixQuantSpec` 16/32-bit two's-complement activations as
              digit vectors; exact `radix_linear`/`radix_relu` layers
              (`lower_mlp_radix`, `lower_gpt2_block_radix`) that run on
              the "eager" and "local" backends.
"""
from repro_torch.fhe_ml.quantize import (QuantSpec, RadixQuantSpec,  # noqa: F401
                                         calibrate_radix, check_radix_range,
                                         dequantize, dequantize_radix,
                                         quantize_affine, quantize_to_radix)
from repro_torch.fhe_ml.lower import (lower_gpt2_block,  # noqa: F401
                                      lower_gpt2_block_radix, lower_mlp,
                                      lower_mlp_radix)
from repro_torch.fhe_ml.executor import FheExecutor  # noqa: F401
