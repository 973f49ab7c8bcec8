"""The paper's benchmarks on the port: Table I and Fig. 8 (LeNet parts); the
mesh harnesses; the roofline of the dry run's records and K1's tile sweep."""
