"""The port's serving paths over a device mesh: the sharding rules and the
single-controller shard runner (``sharding.py``), the sharded MIPS top-k
(``topk.py``), seq-sharded decode attention (``decode_attn.py``) and
expert-parallel MoE (``moe_parallel.py``)."""
