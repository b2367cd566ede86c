"""Blockwise tasks and workflows of the port: watershed (single- and
two-pass), connected components, relabel, write and copy, the graph,
features, costs, multicut and agglomerative-clustering tasks, the
prediction tasks: CNN inference (``inference``) and ilastik
pixel-classification prediction (``ilastik``), the fused mesh step
(``fused``: ``FusedSegmentationWorkflow``), and the postprocessing,
analysis and export tasks: ``postprocess``, ``statistics``,
``downscaling``, ``morphology``, ``node_labels``, ``evaluation``,
``distances``, ``skeletons``, ``meshes``, ``transformations``,
``paintera``, ``label_multisets`` and ``debugging``."""
