"""Blockwise tasks and workflows of the port: watershed (single- and
two-pass), connected components, relabel, write and copy, and the graph,
features, costs, multicut and agglomerative-clustering tasks."""
