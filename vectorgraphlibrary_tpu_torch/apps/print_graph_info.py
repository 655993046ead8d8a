"""Graph info utility (port of apps/print_graph_info.py; reference
apps/utilites print_graph_info): degree statistics of the app's graph, the
same flags as every app.

    python -m vectorgraphlibrary_tpu_torch.apps.print_graph_info -s 14 -e 16
"""
import json

from ..runtime import cli, runtime
from ..utils import analytics


def main(argv=None) -> None:
    cfg = cli.parse_args(argv, "print_graph_info")
    ec = runtime.load_edges(cfg)
    analytics.print_graph_info(ec)
    print(json.dumps(analytics.analyse_degrees(ec), indent=1))


if __name__ == "__main__":
    main()
