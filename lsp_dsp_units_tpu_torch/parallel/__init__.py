"""The sharded layer on ``torch.distributed``, the port of the JAX
package's ``parallel/``: a ('chan', 'time') device mesh, halo exchange
for carried DSP state, time-sharded IIR cascades and global meters.  Each
rank holds plain local tensors; a JAX axis name becomes the mesh's
process group for that dimension."""
