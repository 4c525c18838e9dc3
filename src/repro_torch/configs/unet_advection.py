"""Paper-faithful workload: UNet on the (1-D) Advection PDE (PDEBench).

The paper uses the PDEBench UNet on the Advection dataset (batch 50); the
reference reduces it to a 1-D conv UNet surrogate u(x, t) -> u(x, t+dt)
on synthetic advection data (``data.synthetic.advection_batch``), a conv
net with a compute profile unlike the transformers' (paper §5.1).
Counterpart of ``repro.configs.unet_advection.CONFIG``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="unet-advection",
    family="pde",
    d_model=32,               # base channel count
    vocab_size=1,             # regression: 1 output channel
    pattern=("unet",),        # handled specially by models.api
    n_units=4,                # depth of the U (number of down/up stages)
    act="gelu",
    max_seq_len=128,          # spatial resolution
    default_particles=8,
)
