"""The scale axes: on one host `-devices N` (parallel/devices.py, read data
parallelism over N replicas of the device backend) and `-shards N`
(parallel/sharded_index.py, the occ3 index split over N devices; with
big_x64 parallel/big_index.py); across hosts `run_host`
(parallel/multihost.py: a process per host in a torch.distributed gloo
group, one sum all-reduce of the raw evidence planes) and its
single-process form `merge_engines` (parallel/distributed.py); and the
one-process multichip pipeline over a device list, `run_mesh_pe_pipeline`
(parallel/mesh.py: read batches split over the devices, the evidence
partials and the genome-sharded coverage reduced by the collective
kernels of ops/mesh_kernels.py)."""
