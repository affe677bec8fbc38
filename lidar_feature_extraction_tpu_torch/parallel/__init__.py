"""Multi-device execution: the mesh over a ``torch.distributed`` process
group (``mesh``), bringing the group up and feeding per-rank shards
(``multihost``), the batched localizer, on one device or sharded over a
mesh (``distributed``), and the keyframe graph back ends, on one device
or with their normal equations summed over the ranks (``pose_graph``,
``imu_graph``)."""
