"""The small sizes at which the tests drive a cell on the host."""

CONFIG = {
    "n_per_node": 60,
    "median": {"n_angles": 64, "max_epochs": 8},
    "maxmarg": {"max_epochs": 4, "max_support": 4, "steps": 200,
                "stages": 3, "lam": 0.001},
}
TRAFFIC = {"seeds": 4}
SEED = 2 ** 31 + 12345
