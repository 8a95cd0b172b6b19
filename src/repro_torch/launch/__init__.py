"""Launchers of the port: the device mesh (``launch.mesh``), LM serving
(``launch.serve``) and LM training (``launch.train``: ``pick_mesh_shape``
and ``main`` over ``runtime.train_loop.TrainLoop``).

The reference's sharded serving (``--model-axis``), dry run, roofline,
hill-climb and report (the XLA tooling) are ROADMAP A parts 5 and 7.
"""
