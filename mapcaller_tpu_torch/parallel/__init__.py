"""The single-host scale axes: `-devices N` (parallel/devices.py, read data
parallelism over N replicas of the device backend) and `-shards N`
(parallel/sharded_index.py, the occ3 index split over N devices)."""
