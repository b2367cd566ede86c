"""Blockwise tasks and workflows of the port: watershed (single- and
two-pass), connected components, relabel, write and copy, the graph,
features, costs, multicut and agglomerative-clustering tasks, the
prediction tasks: CNN inference (``inference``) and ilastik
pixel-classification prediction (``ilastik``), and the fused mesh step
(``fused``: ``FusedSegmentationWorkflow``)."""
