"""Task runtime of the port: the DAG engine, the per-block executor and the
storage rung of the handoffs."""
