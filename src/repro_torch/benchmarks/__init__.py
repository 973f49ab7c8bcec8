"""The paper's benchmarks on the port: Table I and Fig. 8 (LeNet parts)."""
