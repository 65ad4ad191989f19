"""The SSM sequence mixers: RWKV-6 (rwkv6-1.6b) and Mamba (jamba's
non-attention layers); the PyTorch counterpart of ``repro/models/ssm``."""
from repro_torch.models.ssm.rwkv6 import rwkv6_block, rwkv_channel_mix, RWKVState  # noqa: F401
from repro_torch.models.ssm.mamba import mamba_block, MambaState  # noqa: F401
