"""A tiny copy of the benchmark's data for CPU tests: a checkout root
holding BENCHMARK.json and mcbench/ data files (configurations, traffic,
the metric readers, peaks) at a size the CPU port maps in seconds."""
import glob
import json
import os
import shutil

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def make_root(d, pairs=1500, length=30000, gvcf=False, extra_metrics=()):
    """A root at d with one cell `tiny.cell` (config `tiny`, traffic
    `tiny`), every per-layer metric of BENCHMARK.json and `extra_metrics`
    ((name, source) pairs written as metrics/<name>.py)."""
    os.makedirs(os.path.join(d, "mcbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(d, "mcbench", "traffic"), exist_ok=True)
    os.makedirs(os.path.join(d, "mcbench", "metrics"), exist_ok=True)
    with open(os.path.join(BENCH, "configs", "ecoli_mg1655.json")) as f:
        cfg = json.load(f)
    cfg.update(name="tiny", genome_length=length, genome_seed=11)
    traffic = "gvcf30x" if gvcf else "wgs50x"
    with open(os.path.join(BENCH, "traffic", traffic + ".json")) as f:
        tr = json.load(f)
    tr.update(pairs=pairs, nor_sample=500)
    tr["rates"] = dict(tr["rates"], inv=0, tnl=0, cnv=0)
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    bench["configs"] = [dict(bench["configs"][0], name="tiny",
                             file="mcbench/configs/tiny.json")]
    bench["workloads"] = [dict(bench["workloads"][0], name="tiny.cell",
                               config="tiny", traffic="tiny")]
    for m in bench["per_layer"]:
        m["workloads"] = ["tiny.cell"]
    for name, src in extra_metrics:
        bench["per_layer"].append(dict(bench["per_layer"][0], name=name))
        with open(os.path.join(d, "mcbench", "metrics", name + ".py"),
                  "w") as f:
            f.write(src)
    for path, obj in (("BENCHMARK.json", bench),
                      ("mcbench/configs/tiny.json", cfg),
                      ("mcbench/traffic/tiny.json", tr)):
        with open(os.path.join(d, path), "w") as f:
            json.dump(obj, f)
    for f in glob.glob(os.path.join(BENCH, "metrics", "*")):
        shutil.copy(f, os.path.join(d, "mcbench", "metrics"))
    shutil.copy(os.path.join(BENCH, "peaks.json"), os.path.join(d, "mcbench"))
    return d


# the CPU's plain seed scan costs its padded batch: batches of 1,024
# reads (the repository's CPU tests pin 256)
SMALL_BATCHES = dict(batch_size=1024, stream_batch_size=1024)


def small_batches(program_config):
    def wrapped(*a, **k):
        cfg, cmd = program_config(*a, **k)
        for key, v in SMALL_BATCHES.items():
            setattr(cfg, key, v)
        return cfg, cmd
    return wrapped


def run(root, capsys, monkeypatch, seed=5, seconds=60.0, trace=0):
    """harness.main on the CPU; -> (rc, the result line or None, stderr)."""
    from mcbench import harness
    monkeypatch.setattr(harness, "program_config",
                        small_batches(harness.program_config))
    rc = harness.main(["--workload", "tiny.cell", "--seed", str(seed),
                       "--seconds", str(seconds), "--trace", str(trace)],
                      device="cpu", root=root)
    out, err = capsys.readouterr()
    lines = out.strip().splitlines()
    return rc, (json.loads(lines[-1]) if rc == 0 and lines else None), err
