"""Run a command and write each line it prints, prefixed with the seconds
since it started, to a log file; exits with the command's code.

    python scripts/torch_timed_run.py chiprun_out/timed.log python3 -u chip_smoke.py

Where the time of ``chip_smoke.py`` goes, phase by phase and line by line.
"""
import subprocess
import sys
import time


def main(argv):
    log, cmd = argv[0], argv[1:]
    t0 = time.perf_counter()
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        for line in proc.stdout:
            out.write(f"{time.perf_counter() - t0:8.1f} {line}")
            out.flush()
    return proc.wait()


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
