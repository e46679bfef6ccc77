import numpy as np
import pytest

from repro.core import CSRGraph, pagerank_system, power_law_graph


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the test skips itself without one)",
    )


def pytest_addoption(parser):
    parser.addoption(
        "--repro-seed", action="store", type=int, default=0,
        help="base RNG seed for seeded_rng-consuming tests "
        "(chaos/property suites) — replay a failure log by passing the "
        "seed it printed",
    )


@pytest.fixture(scope="session")
def repro_seed(request) -> int:
    """The --repro-seed value: fold into any test-local derived seeds."""
    return int(request.config.getoption("--repro-seed"))


@pytest.fixture
def seeded_rng(repro_seed) -> np.random.Generator:
    """THE generator randomized tests draw from.  Centralized so every
    chaos/property run is replayable: `pytest --repro-seed=N` reproduces
    the exact graphs, deltas, and chaos plans of a logged failure."""
    return np.random.default_rng(repro_seed)


@pytest.fixture(scope="session")
def small_pagerank():
    """(P, b, x_dense) for a 300-node power-law PageRank system."""
    g = power_law_graph(300, seed=3)
    p, b = pagerank_system(g, damping=0.85)
    x = np.linalg.solve(np.eye(g.n) - p.to_dense(), b)
    return p, b, x


@pytest.fixture(scope="session")
def skewed_pagerank():
    """Out-degree-ordered 1000-node system (paper Table 2 protocol)."""
    g = power_law_graph(1000, seed=0)
    order = np.argsort(-g.out_degree(), kind="stable")
    g = g.reorder(order)
    p, b = pagerank_system(g, damping=0.85)
    x = np.linalg.solve(np.eye(g.n) - p.to_dense(), b)
    return p, b, x
