"""Launchers of the port: the device mesh (``launch.mesh``), LM serving
(``launch.serve``), LM training (``launch.train``: ``pick_mesh_shape``
and ``main`` over ``runtime.train_loop.TrainLoop``), and the tooling that
runs on no device: the dry run over the production mesh on the meta
device (``launch.dryrun``), the roofline (``launch.roofline``), its named
experiments (``launch.hillclimb``) and the tables (``launch.report``).
"""
