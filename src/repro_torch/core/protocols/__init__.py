from repro_torch.core.protocols import kparty, one_way, two_way  # noqa: F401
