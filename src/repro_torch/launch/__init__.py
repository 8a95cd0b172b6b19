"""Launchers of the port: the device mesh (``launch.mesh``) and LM serving
(``launch.serve``).

The reference's sharded serving, train launcher, dry run and roofline wait
for later parts of ROADMAP slice 12b.
"""
