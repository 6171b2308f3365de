"""The dense LM stack, serving half: layers, attention with a KV cache,
blocks and the LM's prefill/decode entry points (plain PyTorch; the JAX
package has no Pallas kernel here either)."""
