"""scheduler_perf-equivalent benchmark harness of the port: the op DSL, a
1s-window throughput collector and the SchedulingBasic workload, driven
through the production Scheduler + Hub path."""
