"""Port of tempo_tpu/api (the params schema and the single binary's server).

HTTP API: param schema + server.

Reference: pkg/api (paths http.go:54-62, ParseSearchRequest:89,
ParseSearchBlockRequest:213, BuildSearchBlockRequest:361) and the
weaveworks server hosting in cmd/tempo. The param schema is the
contract between the frontend's shards and queriers/serverless workers.
"""

from tempo_tpu_torch.api.params import (
    PATH_ECHO,
    PATH_SEARCH,
    PATH_SEARCH_TAG_VALUES,
    PATH_SEARCH_TAGS,
    PATH_TRACES,
    build_search_block_params,
    parse_duration_ns,
    parse_search_block_request,
    parse_search_request,
    parse_trace_id,
)

__all__ = [
    "PATH_ECHO",
    "PATH_SEARCH",
    "PATH_SEARCH_TAG_VALUES",
    "PATH_SEARCH_TAGS",
    "PATH_TRACES",
    "build_search_block_params",
    "parse_duration_ns",
    "parse_search_block_request",
    "parse_search_request",
    "parse_trace_id",
]
