"""Launchers of the port: the device mesh (``launch.mesh``).

The reference's production mesh, dry run, roofline and train / serve
launchers belong to the LM side (ROADMAP slice 12b).
"""
