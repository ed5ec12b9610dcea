"""Command-line entry points of the port: train and serve."""


def add_device_arg(parser):
    """``--device``: the torch device a CLI runs on; the CUDA card unless
    'cpu' (or another device) is asked for (``device.resolve_device``)."""
    parser.add_argument('--device', default=None,
                        help="torch device: default the CUDA card; 'cpu' "
                             'on request')
    return parser
