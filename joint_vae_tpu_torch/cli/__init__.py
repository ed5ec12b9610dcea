"""Command-line entry points of the port: train, serve, test, results and
ft, and the analysis drivers sample (reconstruction and generation grids,
latent exports), aggregate (ensembles), cascade (chained reconstructions)
and grid (sweeps of the train CLI)."""


def add_device_arg(parser):
    """``--device``: the torch device a CLI runs on; the CUDA card unless
    'cpu' (or another device) is asked for (``device.resolve_device``)."""
    parser.add_argument('--device', default=None,
                        help="torch device: default the CUDA card; 'cpu' "
                             'on request')
    return parser


def add_mesh_args(parser):
    """The JAX package's mesh flags, parsed to be refused
    (``utils/parameters.py::refuse_unported``, ROADMAP Queue 1 item 14)."""
    parser.add_argument('--mesh', nargs='?', const='all', default=None,
                        metavar='N', help='(not ported yet)')
    parser.add_argument('--model-axis', type=int, default=1,
                        help='(not ported yet)')
    parser.add_argument('--sample-axis', type=int, default=1,
                        help='(not ported yet)')
    parser.add_argument('--distributed', action='store_true',
                        help='(not ported yet)')
    return parser
