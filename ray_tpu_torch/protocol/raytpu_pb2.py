# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: raytpu.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0craytpu.proto\x12\x06raytpu"z\n\x08Envelope\x12\x0b\n\x03seq\x18\x01 \x01(\x04\x12\x0e\n\x06method\x18\x02 \x01(\r\x12\r\n\x05reply\x18\x03 \x01(\x08\x12\r\n\x05error\x18\x04 \x01(\t\x12\x0c\n\x04body\x18\x05 \x01(\x0c\x12\x0f\n\x07raw_len\x18\x06 \x01(\x04\x12\x14\n\x05trace\x18\x07 \x01(\tR\x05trace"l\n\tResources\x12/\n\x07amounts\x18\x01 \x03(\x0b2\x1e.raytpu.Resources.AmountsEntry\x1a.\n\x0cAmountsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x01:\x028\x01"\x87\x03\n\x08NodeInfo\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x0f\n\x07address\x18\x02 \x01(\t\x12 \n\x05total\x18\x03 \x01(\x0b2\x11.raytpu.Resources\x12$\n\tavailable\x18\x04 \x01(\x0b2\x11.raytpu.Resources\x12,\n\x06labels\x18\x05 \x03(\x0b2\x1c.raytpu.NodeInfo.LabelsEntry\x12\r\n\x05alive\x18\x06 \x01(\x08\x12\x19\n\x11last_heartbeat_ms\x18\x07 \x01(\x01\x12\x0f\n\x07is_head\x18\x08 \x01(\x08\x12\x14\n\x0cdeath_reason\x18\t \x01(\t\x12\x14\n\x05state\x18\n \x01(\tR\x05state\x12*\n\x11drain_deadline_ms\x18\x0b \x01(\x01R\x0fdrainDeadlineMs\x12!\n\x0cdrain_reason\x18\x0c \x01(\tR\x0bdrainReason\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"5\n\x13RegisterNodeRequest\x12\x1e\n\x04info\x18\x01 \x01(\x0b2\x10.raytpu.NodeInfo"B\n\x11RegisterNodeReply\x12\x16\n\x0eserver_time_ms\x18\x01 \x01(\x01\x12\x15\n\rcluster_epoch\x18\x02 \x01(\x04"V\n\x10HeartbeatRequest\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12$\n\tavailable\x18\x02 \x01(\x0b2\x11.raytpu.Resources\x12\x0b\n\x03seq\x18\x03 \x01(\x04"\xb8\x01\n\x0eHeartbeatReply\x12\x12\n\nrecognized\x18\x01 \x01(\x08\x12\x1d\n\nnode_state\x18\x02 \x01(\tR\tnodeState\x12*\n\x11drain_deadline_ms\x18\x03 \x01(\x01R\x0fdrainDeadlineMs\x12!\n\x0cdrain_reason\x18\x04 \x01(\tR\x0bdrainReason\x12$\n\x0eserver_time_ms\x18\x05 \x01(\x01R\x0cserverTimeMs"1\n\x0eListNodesReply\x12\x1f\n\x05nodes\x18\x01 \x03(\x0b2\x10.raytpu.NodeInfo"6\n\x13MarkNodeDeadRequest\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x0e\n\x06reason\x18\x02 \x01(\t"b\n\x10DrainNodeRequest\x12\x17\n\x07node_id\x18\x01 \x01(\x0cR\x06nodeId\x12\x16\n\x06reason\x18\x02 \x01(\tR\x06reason\x12\x1d\n\ndeadline_s\x18\x03 \x01(\x01R\tdeadlineS"\x07\n\x05Empty"I\n\x0cKvPutRequest\x12\n\n\x02ns\x18\x01 \x01(\x0c\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c\x12\x11\n\toverwrite\x18\x04 \x01(\x08"\x1b\n\nKvPutReply\x12\r\n\x05added\x18\x01 \x01(\x08"\'\n\x0cKvGetRequest\x12\n\n\x02ns\x18\x01 \x01(\x0c\x12\x0b\n\x03key\x18\x02 \x01(\x0c"*\n\nKvGetReply\x12\r\n\x05found\x18\x01 \x01(\x08\x12\r\n\x05value\x18\x02 \x01(\x0c"\'\n\x0cKvDelRequest\x12\n\n\x02ns\x18\x01 \x01(\x0c\x12\x0b\n\x03key\x18\x02 \x01(\x0c"\x1d\n\nKvDelReply\x12\x0f\n\x07deleted\x18\x01 \x01(\x08"+\n\rKvKeysRequest\x12\n\n\x02ns\x18\x01 \x01(\x0c\x12\x0e\n\x06prefix\x18\x02 \x01(\x0c"\x1b\n\x0bKvKeysReply\x12\x0c\n\x04keys\x18\x01 \x03(\x0c"$\n\x10SubscribeRequest\x12\x10\n\x08channels\x18\x01 \x03(\t"F\n\x05Event\x12\x0f\n\x07channel\x18\x01 \x01(\t\x12\x0c\n\x04kind\x18\x02 \x01(\t\x12\x0f\n\x07payload\x18\x03 \x01(\x0c\x12\r\n\x05ts_ms\x18\x04 \x01(\x01".\n\x0ePublishRequest\x12\x1c\n\x05event\x18\x01 \x01(\x0b2\r.raytpu.Event"D\n\x10ObjectLocRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x0f\n\x07node_id\x18\x02 \x01(\x0c\x12\x0c\n\x04size\x18\x03 \x01(\x04"(\n\x13GetLocationsRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c"F\n\x11GetLocationsReply\x12\x10\n\x08node_ids\x18\x01 \x03(\x0c\x12\x11\n\taddresses\x18\x02 \x03(\t\x12\x0c\n\x04size\x18\x03 \x01(\x04"\xc2\x01\n\tActorInfo\x12\x10\n\x08actor_id\x18\x01 \x01(\x0c\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t\x12\x12\n\nclass_name\x18\x04 \x01(\t\x12\x0f\n\x07node_id\x18\x05 \x01(\x0c\x12\x0f\n\x07address\x18\x06 \x01(\t\x12\r\n\x05state\x18\x07 \x01(\t\x12\x15\n\rrestart_count\x18\x08 \x01(\r\x12\x11\n\towner_job\x18\t \x01(\x0c\x12\x13\n\x0bdeath_cause\x18\n \x01(\t"7\n\x14RegisterActorRequest\x12\x1f\n\x04info\x18\x01 \x01(\x0b2\x11.raytpu.ActorInfo"#\n\x0fGetActorRequest\x12\x10\n\x08actor_id\x18\x01 \x01(\x0c"7\n\x14GetNamedActorRequest\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t"<\n\nActorReply\x12\r\n\x05found\x18\x01 \x01(\x08\x12\x1f\n\x04info\x18\x02 \x01(\x0b2\x11.raytpu.ActorInfo"4\n\x0fListActorsReply\x12!\n\x06actors\x18\x01 \x03(\x0b2\x11.raytpu.ActorInfo"\x95\x01\n\x06PgInfo\x12\r\n\x05pg_id\x18\x01 \x01(\x0c\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x10\n\x08strategy\x18\x03 \x01(\t\x12"\n\x07bundles\x18\x04 \x03(\x0b2\x11.raytpu.Resources\x12\x14\n\x0cbundle_nodes\x18\x05 \x03(\x0c\x12\r\n\x05state\x18\x06 \x01(\t\x12\x13\n\x0bcreator_job\x18\x07 \x01(\x0c"1\n\x11RegisterPgRequest\x12\x1c\n\x04info\x18\x01 \x01(\x0b2\x0e.raytpu.PgInfo"+\n\x0cListPgsReply\x12\x1b\n\x03pgs\x18\x01 \x03(\x0b2\x0e.raytpu.PgInfo" \n\x0fRemovePgRequest\x12\r\n\x05pg_id\x18\x01 \x01(\x0c"\xb4\x01\n\x07JobInfo\x12\x0e\n\x06job_id\x18\x01 \x01(\x0c\x12\x16\n\x0edriver_address\x18\x02 \x01(\t\x12\r\n\x05state\x18\x03 \x01(\t\x12\x10\n\x08start_ms\x18\x04 \x01(\x01\x12/\n\x08metadata\x18\x05 \x03(\x0b2\x1d.raytpu.JobInfo.MetadataEntry\x1a/\n\rMetadataEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x028\x01"3\n\x12RegisterJobRequest\x12\x1d\n\x04info\x18\x01 \x01(\x0b2\x0f.raytpu.JobInfo".\n\rListJobsReply\x12\x1d\n\x04jobs\x18\x01 \x03(\x0b2\x0f.raytpu.JobInfo"q\n\nStatsReply\x122\n\x08counters\x18\x01 \x03(\x0b2 .raytpu.StatsReply.CountersEntry\x1a/\n\rCountersEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\x04:\x028\x01"\x9f\x04\n\x0bTaskSpecMsg\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\x0e\n\x06job_id\x18\x02 \x01(\x0c\x12\x15\n\rfunction_name\x18\x03 \x01(\t\x12\x0f\n\x07fn_hash\x18\x04 \x01(\x0c\x12\x13\n\x0bargs_pickle\x18\x05 \x01(\x0c\x12\x13\n\x0bnum_returns\x18\x06 \x01(\r\x12$\n\tresources\x18\x07 \x01(\x0b2\x11.raytpu.Resources\x12\x12\n\nreturn_ids\x18\x08 \x03(\x0c\x12\x0f\n\x07attempt\x18\t \x01(\r\x12\x13\n\x0bmax_retries\x18\n \x01(\r\x12\x10\n\x08actor_id\x18\x0b \x01(\x0c\x12\x13\n\x0bmethod_name\x18\x0c \x01(\t\x12\x18\n\x10runtime_env_json\x18\r \x01(\x0c\x12\x16\n\x0ecaller_address\x18\x0e \x01(\t\x12\r\n\x05pg_id\x18\x0f \x01(\x0c\x12\x17\n\x0fpg_bundle_index\x18\x10 \x01(\x05\x12\x1f\n\x17retry_exceptions_pickle\x18\x11 \x01(\x0c\x12\x0c\n\x04name\x18\x12 \x01(\t\x12\x16\n\x0enamed_function\x18\x13 \x01(\t\x12\x11\n\targs_json\x18\x14 \x01(\x0c\x12\x14\n\x0cjson_results\x18\x15 \x01(\x08\x12\x10\n\x08trace_id\x18\x16 \x01(\t\x12\x16\n\x0eparent_span_id\x18\x17 \x01(\t\x12"\n\rperf_submit_s\x18\x18 \x01(\x01R\x0bperfSubmitS"\x9a\x01\n\rPushTaskReply\x12\x0e\n\x06status\x18\x01 \x01(\t\x12$\n\tavailable\x18\x02 \x01(\x0b2\x11.raytpu.Resources\x12\x16\n\x0einline_results\x18\x03 \x03(\x0c\x12\x0e\n\x06inline\x18\x04 \x03(\x08\x12\x14\n\x0cerror_pickle\x18\x05 \x01(\x0c\x12\x15\n\rerror_message\x18\x06 \x01(\t"\xd3\x01\n\x0cActorSpecMsg\x12\x10\n\x08actor_id\x18\x01 \x01(\x0c\x12\x0e\n\x06job_id\x18\x02 \x01(\x0c\x12\x12\n\nclass_name\x18\x03 \x01(\t\x12\x10\n\x08cls_hash\x18\x04 \x01(\x0c\x12\x13\n\x0bargs_pickle\x18\x05 \x01(\x0c\x12\x16\n\x0eoptions_pickle\x18\x06 \x01(\x0c\x12\x0c\n\x04name\x18\x07 \x01(\t\x12\x11\n\tnamespace\x18\x08 \x01(\t\x12\x16\n\x0ecaller_address\x18\t \x01(\t\x12\x15\n\rrestart_count\x18\n \x01(\r"^\n\x10CreateActorReply\x12\x0e\n\x06status\x18\x01 \x01(\t\x12$\n\tavailable\x18\x02 \x01(\x0b2\x11.raytpu.Resources\x12\x14\n\x0cerror_pickle\x18\x03 \x01(\x0c"8\n\x10KillActorRequest\x12\x10\n\x08actor_id\x18\x01 \x01(\x0c\x12\x12\n\nno_restart\x18\x02 \x01(\x08"3\n\x11CancelTaskRequest\x12\x0f\n\x07task_id\x18\x01 \x01(\x0c\x12\r\n\x05force\x18\x02 \x01(\x08"]\n\x12FetchObjectRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x11\n\tmax_bytes\x18\x03 \x01(\x04\x12\x11\n\tarena_key\x18\x04 \x01(\t"\x92\x01\n\x10FetchObjectReply\x12\r\n\x05found\x18\x01 \x01(\x08\x12\x12\n\ntotal_size\x18\x02 \x01(\x04\x12\x0c\n\x04data\x18\x03 \x01(\x0c\x12\x0b\n\x03eof\x18\x04 \x01(\x08\x12\x14\n\x0cerror_pickle\x18\x05 \x01(\x0c\x12\x10\n\x08in_arena\x18\x06 \x01(\x08\x12\x18\n\x10arena_object_key\x18\x07 \x01(\x0c"e\n\x11PushObjectRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x0e\n\x06offset\x18\x02 \x01(\x04\x12\x12\n\ntotal_size\x18\x03 \x01(\x04\x12\x0c\n\x04data\x18\x04 \x01(\x0c\x12\x0b\n\x03eof\x18\x05 \x01(\x08"#\n\x0fPushObjectReply\x12\x10\n\x08accepted\x18\x01 \x01(\x08"\x81\x01\n\x0fTimelineRequest\x12\x13\n\x0bset_enabled\x18\x01 \x01(\x08\x12\x0f\n\x07enabled\x18\x02 \x01(\x08\x12\r\n\x05clear\x18\x03 \x01(\x08\x12\x1f\n\x0bset_tracing\x18\x04 \x01(\x08R\nsetTracing\x12\x18\n\x07tracing\x18\x05 \x01(\x08R\x07tracing"#\n\rTimelineReply\x12\x12\n\nspans_json\x18\x01 \x01(\x0c"@\n\x0cTaskBatchMsg\x12\x0c\n\x04seqs\x18\x01 \x03(\x04\x12"\n\x05tasks\x18\x02 \x03(\x0b2\x13.raytpu.TaskSpecMsg"n\n\nP2PDataMsg\x12\r\n\x05group\x18\x01 \x01(\t\x12\x10\n\x08src_rank\x18\x02 \x01(\r\x12\x10\n\x08dst_rank\x18\x03 \x01(\r\x12\x0f\n\x07p2p_seq\x18\x04 \x01(\x04\x12\r\n\x05dtype\x18\x05 \x01(\t\x12\r\n\x05shape\x18\x06 \x03(\x03"\xeb\x01\n\x10NodeDebugRequest\x12\x11\n\tlog_lines\x18\x01 \x01(\r\x12\x15\n\rinclude_tasks\x18\x02 \x01(\x08\x12\x11\n\tmax_tasks\x18\x03 \x01(\r\x12\'\n\x0finclude_metrics\x18\x04 \x01(\x08R\x0eincludeMetrics\x12!\n\x0ctrace_filter\x18\x05 \x01(\tR\x0btraceFilter\x12%\n\x0einclude_stacks\x18\x06 \x01(\x08R\rincludeStacks\x12\'\n\x0finclude_bundles\x18\x07 \x01(\x08R\x0eincludeBundles"&\n\x0eNodeDebugReply\x12\x14\n\x0cpayload_json\x18\x01 \x01(\x0c"Z\n\rBundleRequest\x12\r\n\x05pg_id\x18\x01 \x01(\x0c\x12\x14\n\x0cbundle_index\x18\x02 \x01(\r\x12$\n\tresources\x18\x03 \x01(\x0b2\x11.raytpu.Resources"\x19\n\x0bBundleReply\x12\n\n\x02ok\x18\x01 \x01(\x08"4\n\rBorrowRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x10\n\x08borrower\x18\x02 \x01(\t"&\n\x11FreeObjectRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c"-\n\tPingReply\x12\x0f\n\x07node_id\x18\x01 \x01(\x0c\x12\x0f\n\x07time_ms\x18\x02 \x01(\x01":\n\x11WaitObjectRequest\x12\x11\n\tobject_id\x18\x01 \x01(\x0c\x12\x12\n\ntimeout_ms\x18\x02 \x01(\x01" \n\x0fWaitObjectReply\x12\r\n\x05ready\x18\x01 \x01(\x08"<\n\rJournalRecord\x12\x0e\n\x06method\x18\x01 \x01(\r\x12\x0c\n\x04body\x18\x02 \x01(\x0c\x12\r\n\x05ts_ms\x18\x03 \x01(\x01"\x84\x02\n\rStateSnapshot\x12\x1f\n\x05nodes\x18\x01 \x03(\x0b2\x10.raytpu.NodeInfo\x12!\n\x06actors\x18\x02 \x03(\x0b2\x11.raytpu.ActorInfo\x12\x1b\n\x03pgs\x18\x03 \x03(\x0b2\x0e.raytpu.PgInfo\x12\x1d\n\x04jobs\x18\x04 \x03(\x0b2\x0f.raytpu.JobInfo\x12)\n\x02kv\x18\x05 \x03(\x0b2\x1d.raytpu.StateSnapshot.KvEntry\x12\x15\n\rcluster_epoch\x18\x06 \x01(\x04\x1a1\n\x07KvEntry\x12\n\n\x02ns\x18\x01 \x01(\x0c\x12\x0b\n\x03key\x18\x02 \x01(\x0c\x12\r\n\x05value\x18\x03 \x01(\x0c*\xab\x06\n\x06Method\x12\x16\n\x12METHOD_UNSPECIFIED\x10\x00\x12\x11\n\rREGISTER_NODE\x10\x01\x12\r\n\tHEARTBEAT\x10\x02\x12\x0e\n\nLIST_NODES\x10\x03\x12\x12\n\x0eMARK_NODE_DEAD\x10\x04\x12\x0e\n\nDRAIN_NODE\x10\x05\x12\n\n\x06KV_PUT\x10\n\x12\n\n\x06KV_GET\x10\x0b\x12\n\n\x06KV_DEL\x10\x0c\x12\x0b\n\x07KV_KEYS\x10\r\x12\r\n\tSUBSCRIBE\x10\x14\x12\x0b\n\x07PUBLISH\x10\x15\x12\x10\n\x0cADD_LOCATION\x10\x1e\x12\x13\n\x0fREMOVE_LOCATION\x10\x1f\x12\x11\n\rGET_LOCATIONS\x10 \x12\x12\n\x0eREGISTER_ACTOR\x10(\x12\x10\n\x0cUPDATE_ACTOR\x10)\x12\r\n\tGET_ACTOR\x10*\x12\x13\n\x0fGET_NAMED_ACTOR\x10+\x12\x0f\n\x0bLIST_ACTORS\x10,\x12\x0f\n\x0bREGISTER_PG\x102\x12\r\n\tUPDATE_PG\x103\x12\x0c\n\x08LIST_PGS\x104\x12\r\n\tREMOVE_PG\x105\x12\x10\n\x0cREGISTER_JOB\x10<\x12\r\n\tLIST_JOBS\x10=\x12\x0f\n\x0bSTATE_STATS\x10F\x12\x0e\n\nCHECKPOINT\x10G\x12\r\n\tPUSH_TASK\x10d\x12\x10\n\x0cCREATE_ACTOR\x10f\x12\x0e\n\nACTOR_CALL\x10g\x12\x0e\n\nKILL_ACTOR\x10h\x12\x0f\n\x0bCANCEL_TASK\x10i\x12\x10\n\x0cFETCH_OBJECT\x10j\x12\x12\n\x0eRESERVE_BUNDLE\x10l\x12\x0f\n\x0bFREE_BUNDLE\x10m\x12\x0e\n\nADD_BORROW\x10n\x12\x11\n\rREMOVE_BORROW\x10o\x12\x0f\n\x0bFREE_OBJECT\x10p\x12\x08\n\x04PING\x10q\x12\t\n\x05DRAIN\x10r\x12\x0f\n\x0bWAIT_OBJECT\x10s\x12\x0f\n\x0bRELEASE_PIN\x10t\x12\x08\n\x04AUTH\x10u\x12\x0f\n\x0bPUSH_OBJECT\x10v\x12\x10\n\x0cGET_TIMELINE\x10w\x12\x0e\n\nNODE_DEBUG\x10x\x12\x13\n\x0fPUSH_TASK_BATCH\x10y\x12\x0c\n\x08P2P_DATA\x10zb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'raytpu_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RESOURCES_AMOUNTSENTRY._options = None
  _RESOURCES_AMOUNTSENTRY._serialized_options = b'8\001'
  _NODEINFO_LABELSENTRY._options = None
  _NODEINFO_LABELSENTRY._serialized_options = b'8\001'
  _JOBINFO_METADATAENTRY._options = None
  _JOBINFO_METADATAENTRY._serialized_options = b'8\001'
  _STATSREPLY_COUNTERSENTRY._options = None
  _STATSREPLY_COUNTERSENTRY._serialized_options = b'8\001'
  _STATESNAPSHOT_KVENTRY._options = None
  _STATESNAPSHOT_KVENTRY._serialized_options = b'8\001'
  _METHOD._serialized_start=5827
  _METHOD._serialized_end=6638
  _ENVELOPE._serialized_start=24
  _ENVELOPE._serialized_end=146
  _RESOURCES._serialized_start=148
  _RESOURCES._serialized_end=256
  _RESOURCES_AMOUNTSENTRY._serialized_start=210
  _RESOURCES_AMOUNTSENTRY._serialized_end=256
  _NODEINFO._serialized_start=259
  _NODEINFO._serialized_end=650
  _NODEINFO_LABELSENTRY._serialized_start=605
  _NODEINFO_LABELSENTRY._serialized_end=650
  _REGISTERNODEREQUEST._serialized_start=652
  _REGISTERNODEREQUEST._serialized_end=705
  _REGISTERNODEREPLY._serialized_start=707
  _REGISTERNODEREPLY._serialized_end=773
  _HEARTBEATREQUEST._serialized_start=775
  _HEARTBEATREQUEST._serialized_end=861
  _HEARTBEATREPLY._serialized_start=864
  _HEARTBEATREPLY._serialized_end=1010
  _LISTNODESREPLY._serialized_start=1012
  _LISTNODESREPLY._serialized_end=1061
  _MARKNODEDEADREQUEST._serialized_start=1063
  _MARKNODEDEADREQUEST._serialized_end=1117
  _DRAINNODEREQUEST._serialized_start=1119
  _DRAINNODEREQUEST._serialized_end=1217
  _EMPTY._serialized_start=1219
  _EMPTY._serialized_end=1226
  _KVPUTREQUEST._serialized_start=1228
  _KVPUTREQUEST._serialized_end=1301
  _KVPUTREPLY._serialized_start=1303
  _KVPUTREPLY._serialized_end=1330
  _KVGETREQUEST._serialized_start=1332
  _KVGETREQUEST._serialized_end=1371
  _KVGETREPLY._serialized_start=1373
  _KVGETREPLY._serialized_end=1415
  _KVDELREQUEST._serialized_start=1417
  _KVDELREQUEST._serialized_end=1456
  _KVDELREPLY._serialized_start=1458
  _KVDELREPLY._serialized_end=1487
  _KVKEYSREQUEST._serialized_start=1489
  _KVKEYSREQUEST._serialized_end=1532
  _KVKEYSREPLY._serialized_start=1534
  _KVKEYSREPLY._serialized_end=1561
  _SUBSCRIBEREQUEST._serialized_start=1563
  _SUBSCRIBEREQUEST._serialized_end=1599
  _EVENT._serialized_start=1601
  _EVENT._serialized_end=1671
  _PUBLISHREQUEST._serialized_start=1673
  _PUBLISHREQUEST._serialized_end=1719
  _OBJECTLOCREQUEST._serialized_start=1721
  _OBJECTLOCREQUEST._serialized_end=1789
  _GETLOCATIONSREQUEST._serialized_start=1791
  _GETLOCATIONSREQUEST._serialized_end=1831
  _GETLOCATIONSREPLY._serialized_start=1833
  _GETLOCATIONSREPLY._serialized_end=1903
  _ACTORINFO._serialized_start=1906
  _ACTORINFO._serialized_end=2100
  _REGISTERACTORREQUEST._serialized_start=2102
  _REGISTERACTORREQUEST._serialized_end=2157
  _GETACTORREQUEST._serialized_start=2159
  _GETACTORREQUEST._serialized_end=2194
  _GETNAMEDACTORREQUEST._serialized_start=2196
  _GETNAMEDACTORREQUEST._serialized_end=2251
  _ACTORREPLY._serialized_start=2253
  _ACTORREPLY._serialized_end=2313
  _LISTACTORSREPLY._serialized_start=2315
  _LISTACTORSREPLY._serialized_end=2367
  _PGINFO._serialized_start=2370
  _PGINFO._serialized_end=2519
  _REGISTERPGREQUEST._serialized_start=2521
  _REGISTERPGREQUEST._serialized_end=2570
  _LISTPGSREPLY._serialized_start=2572
  _LISTPGSREPLY._serialized_end=2615
  _REMOVEPGREQUEST._serialized_start=2617
  _REMOVEPGREQUEST._serialized_end=2649
  _JOBINFO._serialized_start=2652
  _JOBINFO._serialized_end=2832
  _JOBINFO_METADATAENTRY._serialized_start=2785
  _JOBINFO_METADATAENTRY._serialized_end=2832
  _REGISTERJOBREQUEST._serialized_start=2834
  _REGISTERJOBREQUEST._serialized_end=2885
  _LISTJOBSREPLY._serialized_start=2887
  _LISTJOBSREPLY._serialized_end=2933
  _STATSREPLY._serialized_start=2935
  _STATSREPLY._serialized_end=3048
  _STATSREPLY_COUNTERSENTRY._serialized_start=3001
  _STATSREPLY_COUNTERSENTRY._serialized_end=3048
  _TASKSPECMSG._serialized_start=3051
  _TASKSPECMSG._serialized_end=3558
  _PUSHTASKREPLY._serialized_start=3561
  _PUSHTASKREPLY._serialized_end=3715
  _ACTORSPECMSG._serialized_start=3718
  _ACTORSPECMSG._serialized_end=3929
  _CREATEACTORREPLY._serialized_start=3931
  _CREATEACTORREPLY._serialized_end=4025
  _KILLACTORREQUEST._serialized_start=4027
  _KILLACTORREQUEST._serialized_end=4083
  _CANCELTASKREQUEST._serialized_start=4085
  _CANCELTASKREQUEST._serialized_end=4136
  _FETCHOBJECTREQUEST._serialized_start=4138
  _FETCHOBJECTREQUEST._serialized_end=4231
  _FETCHOBJECTREPLY._serialized_start=4234
  _FETCHOBJECTREPLY._serialized_end=4380
  _PUSHOBJECTREQUEST._serialized_start=4382
  _PUSHOBJECTREQUEST._serialized_end=4483
  _PUSHOBJECTREPLY._serialized_start=4485
  _PUSHOBJECTREPLY._serialized_end=4520
  _TIMELINEREQUEST._serialized_start=4523
  _TIMELINEREQUEST._serialized_end=4652
  _TIMELINEREPLY._serialized_start=4654
  _TIMELINEREPLY._serialized_end=4689
  _TASKBATCHMSG._serialized_start=4691
  _TASKBATCHMSG._serialized_end=4755
  _P2PDATAMSG._serialized_start=4757
  _P2PDATAMSG._serialized_end=4867
  _NODEDEBUGREQUEST._serialized_start=4870
  _NODEDEBUGREQUEST._serialized_end=5105
  _NODEDEBUGREPLY._serialized_start=5107
  _NODEDEBUGREPLY._serialized_end=5145
  _BUNDLEREQUEST._serialized_start=5147
  _BUNDLEREQUEST._serialized_end=5237
  _BUNDLEREPLY._serialized_start=5239
  _BUNDLEREPLY._serialized_end=5264
  _BORROWREQUEST._serialized_start=5266
  _BORROWREQUEST._serialized_end=5318
  _FREEOBJECTREQUEST._serialized_start=5320
  _FREEOBJECTREQUEST._serialized_end=5358
  _PINGREPLY._serialized_start=5360
  _PINGREPLY._serialized_end=5405
  _WAITOBJECTREQUEST._serialized_start=5407
  _WAITOBJECTREQUEST._serialized_end=5465
  _WAITOBJECTREPLY._serialized_start=5467
  _WAITOBJECTREPLY._serialized_end=5499
  _JOURNALRECORD._serialized_start=5501
  _JOURNALRECORD._serialized_end=5561
  _STATESNAPSHOT._serialized_start=5564
  _STATESNAPSHOT._serialized_end=5824
  _STATESNAPSHOT_KVENTRY._serialized_start=5775
  _STATESNAPSHOT_KVENTRY._serialized_end=5824
# @@protoc_insertion_point(module_scope)
