"""PyTorch/CUDA port of the swallow serving stack.

Module paths mirror the JAX reference package ``repro`` (for example
``repro_torch.models.attention`` <-> ``repro.models.attention``).  This
package imports ``torch`` and numpy only, never ``jax`` and never
``repro``: host-side modules the two share are kept here as copies.
"""
