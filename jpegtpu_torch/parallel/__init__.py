"""One image across several devices or processes (counterpart of
`jpegtpu/parallel`): `sharding` splits it into bands of whole MCU rows,
one restart segment (or k) a band; `multihost` joins processes over
torch.distributed."""
